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
// Precision: each element adds y = x - shift to the sums of y, y^2 and
// y^3 in double; shift is the channel's first pixel of the tile, so y is
// centred near the data. Central moments follow from the shifted sums in
// double, where the cancellation costs at most ~1e-16 of E[y^2] or
// E[|y|^3]: far below the float32 output, unlike raw float32 power sums,
// which lose about five digits of the skew.
//
// Design: a thread-block cluster of cs CTAs per tile. A 416x416x3 tile is
// 2 MB, too large for shared memory, and a second pass over it would miss
// the 50 MB L2 once a few dozen tiles are in flight, so every element is
// read once. The tile, seen from its first 16-byte boundary, is a run of
// float4s; CTA r of the cluster reads the contiguous slab [nq*r/cs,
// nq*(r+1)/cs) of them, thread t the float4s t, t + act, t + 2*act, ...
// of its slab, in batches of four loads in flight (64 bytes a thread),
// each batch used in order once all four have arrived. act, the active
// threads, is a multiple of c / gcd(c, 4), so 4*act floats is a multiple
// of c and each of a thread's four lanes keeps one channel from one
// float4 to the next (for C = 3, act = 255: a thread steps by 1020
// floats). The floats before the first boundary and after the last whole
// float4 are a partial float4 each, taken by the thread whose lanes have
// their channels. Each lane keeps its own three double sums.
//
// Reduction, in two steps. In the CTA, for C <= 4 (the Mission's C = 3):
// a thread folds its four lanes into per-channel sums, a warp adds them
// with __shfl_xor_sync, and warp 0 adds the warps' results the same way.
// For C > 4 the lanes of a thread hold four different channels and
// threads t and t + c/gcd(c, 4) hold the same four, so the sums go
// through shared memory, all three sums in one round: one thread a class
// of lanes (lane 4t + j of the CTA and those a multiple of 4*period
// lanes from it, all of one channel) adds its class, then one thread a
// channel adds its channel's 1, 2 or 4 classes. Then across the
// cluster: every CTA leaves its per-channel sums in its shared memory,
// and after cluster.sync() the leader (rank 0) reads them in rank order
// through distributed shared memory (map_shared_rank), finishes the
// moments and writes them; a second cluster.sync() keeps the other CTAs'
// shared memory alive until it has read it.
//
// Cluster size: the largest of 8, 4, 2, 1 for which the n * cs CTAs all
// fit on the card at once (SMs times the CTAs an SM holds, from the
// occupancy API) and every thread of a CTA still has a whole batch of
// four float4s in its slab. Splitting a tile puts more loads in flight
// and spreads a few large tiles over every SM; past one wave it adds
// merges and no bandwidth, and a slab of less than a batch a thread pays
// the merge's latency for nothing. At (256, 416, 416, 3) on an H100 (132
// SMs, 4 CTAs of 256 threads an SM at 64 registers a thread) that is
// cs = 2: 512 CTAs of 1 MB each. The kernel is right for any cs: a tile
// with fewer float4s than the cluster has CTAs leaves some slabs empty,
// and those CTAs add zeros.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;    // CTAs an SM holds: at most 64 registers a thread
constexpr int kMaxC = 64;
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kBatch = 4;        // float4 loads a thread keeps in flight

// a thread's float4 stride, in threads: a multiple of c / gcd(c, 4)
__device__ __forceinline__ int channel_period(int c) {
  return (c % 4 == 0) ? c / 4 : (c % 2 == 0) ? c / 2 : c;
}

__device__ __forceinline__ void accumulate(float v, double shift, double& s1, double& s2,
                                           double& s3) {
  const double y = (double)v - shift;
  s1 += y;
  s2 = fma(y, y, s2);
  s3 = fma(y * y, y, s3);
}

// the four lanes of one thread: lane j sees floats of one channel only
struct Lanes {
  double s1[4], s2[4], s3[4], shift[4];

  __device__ __forceinline__ void add(const float4 v) {
    accumulate(v.x, shift[0], s1[0], s2[0], s3[0]);
    accumulate(v.y, shift[1], s1[1], s2[1], s3[1]);
    accumulate(v.z, shift[2], s1[2], s2[2], s3[2]);
    accumulate(v.w, shift[3], s1[3], s2[3], s3[3]);
  }

  // floats first + j of the tile that lie in [0, hwc)
  __device__ __forceinline__ void add_partial(const float* tile, long long hwc, long long first) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = first + j;
      if (i >= 0 && i < hwc) accumulate(__ldg(tile + i), shift[j], s1[j], s2[j], s3[j]);
    }
  }
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <bool kFewChannels>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tile_moments_kernel(const float* __restrict__ x, float* __restrict__ out, long long hwc, int c) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const float* tile = x + (long long)(blockIdx.x / cs) * hwc;
  const int t = threadIdx.x;
  const int period = channel_period(c);
  const int act = kThreads / period * period;
  // h0 floats before the tile's first 16-byte boundary, then nq whole float4s
  const int h0 = (int)(((16u - ((unsigned)(uintptr_t)tile & 15u)) & 15u) / 4u);
  const long long nq = hwc > h0 ? (hwc - h0) / 4 : 0;
  const long long q0 = nq * rank / cs, q1 = nq * (rank + 1) / cs;
  // the channel of lane 0 of thread 0 of this CTA: float h0 + 4 * q0
  const int base = (int)((h0 + 4 * (q0 % c)) % c);

  Lanes L;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    L.shift[j] = (double)__ldg(tile + (base + 4 * t + j) % c);
    L.s1[j] = L.s2[j] = L.s3[j] = 0.0;
  }
  if (t < act) {
    // float4 -1 (the floats before the boundary) belongs to thread act - 1
    if (rank == 0 && t == act - 1) L.add_partial(tile, hwc, (long long)h0 - 4);
    const float4* body = reinterpret_cast<const float4*>(tile + h0);
    for (long long q = q0 + t; q < q1; q += kBatch * act) {
      float4 v[kBatch];  // all loads of a batch in flight before the first use
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (q + u * act < q1) v[u] = __ldg(body + q + u * act);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (q + u * act < q1) L.add(v[u]);
      }
    }
    // float4 nq (the floats past the last whole float4), the last CTA's
    if (rank == cs - 1 && t == (int)((nq - q0) % act)) L.add_partial(tile, hwc, h0 + 4 * nq);
  }

  // this CTA's sums by channel, read by the cluster's leader
  __shared__ double part[kMaxC][3];
  if constexpr (kFewChannels) {
    __shared__ double warp_part[kWarps][4][3];
    double r[4][3];
#pragma unroll
    for (int s = 0; s < 4; ++s) r[s][0] = r[s][1] = r[s][2] = 0.0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = (base + 4 * t + j) % c;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (ch == s) {
          r[s][0] += L.s1[j];
          r[s][1] += L.s2[j];
          r[s][2] += L.s3[j];
        }
      }
    }
    const int lane = t % 32, warp = t / 32;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s < c) {
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const double v = warp_sum(r[s][m]);
          if (lane == 0) warp_part[warp][s][m] = v;
        }
      }
    }
    __syncthreads();
    if (warp == 0) {
      for (int s = 0; s < c; ++s) {
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const double v = warp_sum(lane < kWarps ? warp_part[lane][s][m] : 0.0);
          if (lane == 0) part[s][m] = v;
        }
      }
    }
  } else {
    // lane j of thread t is lane 4t + j of the CTA, in class (4t + j) % (4 * period), of
    // channel (base + class) % c; class k holds lanes k, k + 4 * period, ...; channel ch has
    // classes (ch - base) mod c, plus c, plus 2c, ... (4 * period / c of them: 1, 2 or 4)
    __shared__ double lanes[3][kThreads * 4];
    __shared__ double cls[3][kThreads];
    const int classes = 4 * period;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lanes[0][t * 4 + j] = L.s1[j];
      lanes[1][t * 4 + j] = L.s2[j];
      lanes[2][t * 4 + j] = L.s3[j];
    }
    __syncthreads();
    if (t < classes) {
      double a1 = 0.0, a2 = 0.0, a3 = 0.0;
      for (int k = t; k < act * 4; k += classes) {
        a1 += lanes[0][k];
        a2 += lanes[1][k];
        a3 += lanes[2][k];
      }
      cls[0][t] = a1;
      cls[1][t] = a2;
      cls[2][t] = a3;
    }
    __syncthreads();
    if (t < c) {
      double a1 = 0.0, a2 = 0.0, a3 = 0.0;
      for (int k = (t - base + c) % c; k < classes; k += c) {
        a1 += cls[0][k];
        a2 += cls[1][k];
        a3 += cls[2][k];
      }
      part[t][0] = a1;
      part[t][1] = a2;
      part[t][2] = a3;
    }
  }

  cluster.sync();
  if (rank == 0 && t < c) {
    double a1 = 0.0, a2 = 0.0, a3 = 0.0;
    for (int r = 0; r < cs; ++r) {
      const double* p = cluster.map_shared_rank(&part[0][0], r);
      a1 += p[t * 3];
      a2 += p[t * 3 + 1];
      a3 += p[t * 3 + 2];
    }
    const double n = (double)(hwc / c);
    const double my = a1 / n, e2 = a2 / n, e3 = a3 / n;
    const double m2 = fmax(e2 - my * my, 0.0);
    const double m3 = e3 - 3.0 * my * e2 + 2.0 * my * my * my;
    float* o = out + (long long)(blockIdx.x / cs) * 3 * c;
    o[t] = (float)((double)tile[t] + my);
    o[c + t] = sqrtf((float)m2 + 1e-12f);
    o[2 * c + t] = (float)cbrt(m3);
  }
  cluster.sync();  // the leader has read every CTA's part
}

template <bool kFewChannels>
int launch(const float* x, float* out, int n, long long hwc, int c, cudaStream_t stream) {
  static int resident = 0;  // CTAs the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, tile_moments_kernel<kFewChannels>, kThreads, 0);
    }
    if (err != cudaSuccess) return (int)err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  int cs = kMaxCluster;
  while (cs > 1 && ((long long)n * cs > resident || hwc / 4 < (long long)cs * kBatch * kThreads))
    cs /= 2;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, tile_moments_kernel<kFewChannels>, x, out,
                                             hwc, c);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n, hw, c) float32, contiguous (4-byte aligned; any offset from a
// 16-byte boundary); out: (n, 3c) float32. Requires 1 <= c <= 64 and
// hw >= 1. One launch. Returns cudaGetLastError().
extern "C" int tile_moments_f32(const void* x, void* out, int n, int hw, int c,
                                void* stream) {
  if (c < 1 || c > kMaxC || hw < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const long long hwc = (long long)hw * c;
  cudaStream_t s = (cudaStream_t)stream;
  return c <= 4 ? launch<true>((const float*)x, (float*)out, n, hwc, c, s)
                : launch<false>((const float*)x, (float*)out, n, hwc, c, s);
}
