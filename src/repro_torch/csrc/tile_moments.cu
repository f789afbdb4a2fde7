// Color moments of NHWC float32 tiles, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/tile_moments.py (tile_moments,
// _kernel): per tile and channel, mean, sqrtf(m2 + 1e-12) and cbrt(m3),
// with m2 and m3 the second and third moments about the mean. The
// moments and the cube root are taken in double and rounded once, as the
// plain version (kernels/ref.py) does.
//
// Bound: memory. Every input byte is read once (N*H*W*C*4 bytes over
// 3.35 TB/s); the arithmetic is a few operations per element.
//
// Design: one block per tile. A 416x416x3 tile is 2 MB, too large for
// shared memory, and a second pass over it would miss the 50 MB L2 once
// a few dozen tiles are in flight. So the kernel reads each element once
// and keeps, per thread, the sums of y, y^2 and y^3 with y = x - shift,
// in double; shift is the channel's first pixel of the tile, so y is
// centred near the data. Central moments follow from the shifted sums in
// double, where the cancellation costs at most ~1e-16 of E[y^2] or
// E[|y|^3]: far below the float32 output, unlike raw float32 power sums,
// which lose about five digits of the skew. Thread t owns channel t % C
// and strides by a multiple of C, so a warp reads 32 neighbouring floats
// (coalesced) that all belong to its threads' own channels.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
tile_moments_kernel(const float* __restrict__ x, float* __restrict__ out,
                    long long hwc, int c) {
  const float* tile = x + (long long)blockIdx.x * hwc;
  const int t = threadIdx.x;
  const int stride = (kThreads / c) * c;
  const int ch = t % c;
  double s1 = 0.0, s2 = 0.0, s3 = 0.0;
  if (t < stride) {
    const double shift = (double)tile[ch];
    long long i = t;
    for (; i + 3LL * stride < hwc; i += 4LL * stride) {
      const float v0 = __ldg(tile + i);
      const float v1 = __ldg(tile + i + stride);
      const float v2 = __ldg(tile + i + 2LL * stride);
      const float v3 = __ldg(tile + i + 3LL * stride);
      double y = (double)v0 - shift;
      s1 += y; s2 += y * y; s3 += y * y * y;
      y = (double)v1 - shift;
      s1 += y; s2 += y * y; s3 += y * y * y;
      y = (double)v2 - shift;
      s1 += y; s2 += y * y; s3 += y * y * y;
      y = (double)v3 - shift;
      s1 += y; s2 += y * y; s3 += y * y * y;
    }
    for (; i < hwc; i += stride) {
      const double y = (double)__ldg(tile + i) - shift;
      s1 += y; s2 += y * y; s3 += y * y * y;
    }
  }
  __shared__ double r1[kThreads], r2[kThreads], r3[kThreads];
  r1[t] = s1;
  r2[t] = s2;
  r3[t] = s3;
  __syncthreads();
  if (t < c) {
    double a1 = 0.0, a2 = 0.0, a3 = 0.0;
    for (int j = t; j < stride; j += c) {
      a1 += r1[j];
      a2 += r2[j];
      a3 += r3[j];
    }
    const double n = (double)(hwc / c);
    const double my = a1 / n, e2 = a2 / n, e3 = a3 / n;
    const double m2 = fmax(e2 - my * my, 0.0);
    const double m3 = e3 - 3.0 * my * e2 + 2.0 * my * my * my;
    float* o = out + (long long)blockIdx.x * 3 * c;
    o[t] = (float)((double)tile[t] + my);
    o[c + t] = sqrtf((float)m2 + 1e-12f);
    o[2 * c + t] = (float)cbrt(m3);
  }
}

}  // namespace

// x: (n, hw, c) float32, contiguous; out: (n, 3c) float32.
// Requires 1 <= c <= 64 and hw >= 1. Returns cudaGetLastError().
extern "C" int tile_moments_f32(const void* x, void* out, int n, int hw, int c,
                                void* stream) {
  if (n > 0) {
    tile_moments_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, (long long)hw * c, c);
  }
  return (int)cudaGetLastError();
}
