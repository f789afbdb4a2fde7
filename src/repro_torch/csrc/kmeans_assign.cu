// Nearest-centroid assignment for k-means, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/kmeans_assign.py
// (kmeans_assign, _kernel): for x (N, D) and centroids c (K, D),
// d2 = sum(x^2) - 2 x.c + sum(c^2); the argmin as int32 (first index on
// ties) and max(min d2, 0).
//
// Bound: at the dedup's shapes (D = 9, N <= 1024, K <= 512) the work is
// a few MFLOP and a few tens of KB, far below a microsecond of either
// rate, so the launch itself bounds it. The roofline counts
// (N*D + K*D)*4 bytes read, N*8 written, and 2*N*K*D operations.
//
// Design: one thread per row of x, its row in registers. The centroid
// table and each centroid's sum of squares sit in shared memory, loaded
// in chunks when K*D is large; every thread of a warp reads the same
// centroid word at once (a broadcast). fp32 on the CUDA cores: D = 9 is
// too thin for the tensor cores, and TF32 would move assignments. The
// distance is evaluated as the reference writes it, x2 - 2*dot + c2, with
// the last three roundings pinned by __fmul_rn/__fsub_rn/__fadd_rn so
// the compiler cannot contract them; (x - c)^2 would round differently
// and move argmins on near-ties. A strict < keeps the first index.
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int kChunkFloats = 8192;  // 32 KB of centroids (+ norms) per chunk

template <int MAXD>
__global__ void kmeans_assign_kernel(const float* __restrict__ x,
                                     const float* __restrict__ c,
                                     int* __restrict__ assign,
                                     float* __restrict__ dist,
                                     int n, int k, int d, int kc) {
  extern __shared__ float smem[];
  float* cs = smem;            // (kc, d) centroids of this chunk
  float* c2s = smem + kc * d;  // (kc,) their sums of squares
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = row < n;

  float xr[MAXD];
  float x2 = 0.f;
#pragma unroll
  for (int j = 0; j < MAXD; ++j) {
    xr[j] = (live && j < d) ? x[(long long)row * d + j] : 0.f;
    x2 = fmaf(xr[j], xr[j], x2);
  }

  float best = INFINITY;
  int best_j = 0;
  for (int k0 = 0; k0 < k; k0 += kc) {
    const int rows = min(kc, k - k0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
      cs[i] = c[(long long)k0 * d + i];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      float s = 0.f;
      for (int j = 0; j < d; ++j) s = fmaf(cs[i * d + j], cs[i * d + j], s);
      c2s[i] = s;
    }
    __syncthreads();
    if (live) {
      for (int i = 0; i < rows; ++i) {
        const float* ci = cs + i * d;
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < MAXD; ++j) {
          if (j < d) dot = fmaf(xr[j], ci[j], dot);
        }
        const float d2 = __fadd_rn(__fsub_rn(x2, __fmul_rn(2.f, dot)), c2s[i]);
        if (d2 < best) {
          best = d2;
          best_j = k0 + i;
        }
      }
    }
  }
  if (live) {
    assign[row] = best_j;
    dist[row] = fmaxf(best, 0.f);
  }
}

template <int MAXD, int THREADS>
int launch(const float* x, const float* c, int* assign, float* dist, int n,
           int k, int d, cudaStream_t stream) {
  const int kc = std::max(1, std::min(k, kChunkFloats / (d + 1)));
  const size_t smem = (size_t)kc * (d + 1) * sizeof(float);
  const int blocks = (n + THREADS - 1) / THREADS;
  kmeans_assign_kernel<MAXD><<<blocks, THREADS, smem, stream>>>(
      x, c, assign, dist, n, k, d, kc);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n, d) float32, c: (k, d) float32, both contiguous; assign: (n,) int32;
// dist: (n,) float32. Requires n >= 1, k >= 1 and 1 <= d <= 128.
// Returns cudaGetLastError().
extern "C" int kmeans_assign_f32(const void* x, const void* c, void* assign,
                                 void* dist, int n, int k, int d,
                                 void* stream) {
  const float* xf = (const float*)x;
  const float* cf = (const float*)c;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 16) return launch<16, 256>(xf, cf, (int*)assign, (float*)dist, n, k, d, s);
  if (d <= 128) return launch<128, 128>(xf, cf, (int*)assign, (float*)dist, n, k, d, s);
  return (int)cudaErrorInvalidValue;
}
