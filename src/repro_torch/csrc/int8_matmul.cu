// Int8 matrix product with per-row and per-column scales, for Hopper
// (sm_90a), on the CUDA cores' dp4a.
//
// Replaces the Pallas kernel repro/kernels/int8_matmul.py (int8_matmul,
// _kernel): out (M, N) = (float(acc) * x_scale[m]) * w_scale[n] with
// acc = sum_k x_q[m, k] * w_q[k, n] accumulated exactly in int32.
//
// Bound: at the kernel bench's 256 x 512 x 256 the operations
// (2*M*K*N at the int8 tensor-core rate) and the bytes (M*K + K*N
// int8, M*N*4 out) are both microseconds; the launch dominates.
//
// Design: a block of 256 threads owns a 64 x 64 output tile and walks K
// in chunks of 64. Each chunk of x and w is staged in shared memory as
// 32-bit words of four int8 along K (x rows as they lie; w columns packed
// from four rows), zero-filled past M, N and K, so any shape works,
// (1, 64, 1) included. A thread holds a 4 x 4 block of int32 sums and
// adds one __dp4a (four products) a word: exact, so the result equals
// the plain version bit for bit. The epilogue rounds once per multiply
// (__int2float_rn, __fmul_rn), in the reference's order. Tensor-core
// mma (s8 x s8 -> s32) is later work.
#include <cstdint>
#include <cuda_runtime.h>

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
