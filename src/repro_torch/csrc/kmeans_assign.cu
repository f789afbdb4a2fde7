// Nearest-centroid assignment and k-means++ seeding, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/kmeans_assign.py
// (kmeans_assign, _kernel): for x (N, D) and centroids c (K, D),
// d2 = sum(x^2) - 2 x.c + sum(c^2); the argmin as int32 (first index on
// ties) and max(min d2, 0). Two entries, one per caller in the dedup:
//
// kmeans_assign_f32: the Lloyd steps and the final assignment (K =
// k_pad). Bound: at the dedup's shapes (D = 9, N <= 1024, K <= 512) a
// few MFLOP and a few tens of KB, far below a microsecond of either
// rate; the roofline counts (N*D + K*D)*4 bytes read, N*8 written, and
// 2*N*K*D operations. What is left is latency: the launch, loading the
// table, and each centroid's chain of D dependent FMAs. Design: one warp
// per row of x, eight rows a block (1024 rows: 128 blocks, about one a
// SM), the row in every lane's registers. The centroid table and each
// centroid's sum of squares sit in shared memory, loaded in chunks when
// K*D is large (by cp.async, so a chunk's loads are all in flight at
// once: loaded one a loop turn, each cost a memory latency, ~0.3 us a
// turn on an H100), rows padded to an odd stride so the 32 lanes reading 32
// centroids hit 32 banks. Lane l takes centroids l, l + 32, l + 64, ...
// (16 each at K 512, so the 16 FMA chains of a lane overlap) and keeps
// its best (d2, index) with a strict <, as the sequential scan does over
// all K. The warp then takes the lexicographic minimum of (d2 under the
// float <, index) with __shfl_xor_sync. Why that is the sequential
// first-index scan: the scan (best = +inf, replace on d2 < best) ends at
// the lowest index of the least class of d2, where two values are in one
// class when neither is < the other (equal values, and -0 with +0); a NaN
// is never < anything and is never taken. A lane's scan over its own
// centroids, in increasing index, ends at the lowest index of its least
// class, or at (+inf, none) if it took nothing. Taking the least class
// and then the lowest index is associative and commutative over such
// pairs (without NaN, "neither is <" is an equivalence), so the butterfly
// gives every lane the least class over all K and its lowest index: the
// sequential result, with the d2 of that index, bit for bit (-0 or +0 as
// it was, negative values from rounding included). If no lane took any
// centroid (every d2 NaN or +inf) the index is 0, as the scan's initial
// one. fp32 on the CUDA cores: D = 9 is too thin for the tensor cores,
// and TF32 would move assignments. The distance is evaluated as the
// reference writes it, x2 - 2*dot + c2, each sum a chain of fmaf in index
// order, with the last three roundings pinned by
// __fmul_rn/__fsub_rn/__fadd_rn so the compiler cannot contract them;
// (x - c)^2 would round differently and move argmins on near-ties.
//
// kmeanspp_seed_f32: the whole k-means++ seeding of one dedup lane,
// where the reference (repro/core/dedup.py, _dedup_core_body) scans
// k - 1 greedy farthest-point picks, each a one-centroid kmeans_assign,
// an argmax and a min. Bound: a chain of k - 1 dependent block-wide
// reductions, each a few hundred nanoseconds of latency; the bytes (x
// once, the table once) and operations (~3*N*D a pick) are microseconds.
// Design: one block, the loop of picks inside it, as a TPU's sequential
// scan becomes a loop inside one block. x and each row's sum of squares
// stay in shared memory for the whole seeding (N * (D + 1) * 4 bytes: 40
// KB at the dedup's N 1024, D 9); up to 512 threads, each with the running
// d2 of its (at most 16) rows in registers. A pick: every thread updates
// d2 = min(d2, max(x2 - 2*dot + c2, 0)) with the same arithmetic as
// kmeans_assign_kernel and keeps its best (d2, row) with a strict >; a
// warp takes the largest d2 and then the lowest row holding it
// (__reduce_max_sync on the bits of a non-negative float, then
// __reduce_min_sync), so ties go to the first index, as torch.argmax and
// jnp.argmax; after one __syncthreads every warp reduces the warps'
// results the same way (double-buffered, so one barrier a pick), and the
// winner's row is the next centroid, with c2 its own sum of squares. Rows
// past n never win. Centroids are copies of rows of x, so the table
// equals the plain version's bit for bit. When x does not fit (more than
// 16 rows a thread, or more shared memory than a block may hold), a block
// of 1024 threads reads the rows from L2 each pick and keeps d2 in a
// scratch buffer of its own.
//
// Lane entries, for the fleet's dedup (repro/core/dedup.py, dedup_multi,
// which vmaps the one-lane dedup over the satellites of one (n_pad, k_pad)
// bucket): kmeans_assign_lanes_f32 is kmeans_assign_f32 over L lanes in
// one launch, the lane from blockIdx.y (a copy of the kernel, the pointers
// offset by the lane); kmeanspp_seed_lanes_f32 runs the seeding of L lanes
// in one launch, one block a lane, through the same device function as
// kmeanspp_seed_f32 (kmeanspp_smem_body / kmeanspp_l2_body), with each
// lane's n, first pick and k read from a device vector. Lane l of either
// equals the one-lane entry on lane l's inputs bit for bit. Bound: the
// same as the one-lane entries, L times the bytes and operations; the
// seeding's L blocks run their chains side by side on L SMs, so a bucket
// of up to 132 lanes seeds in about one lane's latency.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kChunkFloats = 8192;  // 32 KB of centroids (+ norms) per chunk
constexpr int kAssignWarps = 8;     // rows a block, one a warp

template <int MAXD>
__global__ void __launch_bounds__(kAssignWarps * 32)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     int* __restrict__ assign, float* __restrict__ dist, int n, int k,
                     int d, int ld, int kc) {
  extern __shared__ float smem[];
  float* cs = smem;             // (kc, ld) centroids of this chunk, ld = d | 1
  float* c2s = smem + kc * ld;  // (kc,) their sums of squares
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kAssignWarps + threadIdx.x / 32;
  const bool live = row < n;  // the same for the whole warp

  float xr[MAXD];
  float x2 = 0.f;
#pragma unroll
  for (int j = 0; j < MAXD; ++j) {
    xr[j] = (live && j < d) ? x[(long long)row * d + j] : 0.f;
    x2 = fmaf(xr[j], xr[j], x2);
  }

  float best = INFINITY;
  int best_j = INT_MAX;  // none yet
  for (int k0 = 0; k0 < k; k0 += kc) {
    const int rows = min(kc, k - k0);
    __syncthreads();  // the previous chunk is no longer read
    // cp.async: every load of the chunk in flight at once, not one a loop turn
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
      __pipeline_memcpy_async(cs + (i / d) * ld + i % d, c + (long long)k0 * d + i,
                              sizeof(float));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      float s = 0.f;
      for (int j = 0; j < d; ++j) s = fmaf(cs[i * ld + j], cs[i * ld + j], s);
      c2s[i] = s;
    }
    __syncthreads();
    if (live) {
      for (int i = lane; i < rows; i += 32) {
        const float* ci = cs + i * ld;
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
  // the least (d2, index): the lower index where neither d2 is < the other
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oj = __shfl_xor_sync(0xffffffffu, best_j, off);
    if (ov < best || (!(best < ov) && oj < best_j)) {
      best = ov;
      best_j = oj;
    }
  }
  if (live && lane == 0) {
    assign[row] = best_j == INT_MAX ? 0 : best_j;
    dist[row] = fmaxf(best, 0.f);
  }
}

template <int MAXD>
int launch(const float* x, const float* c, int* assign, float* dist, int n,
           int k, int d, cudaStream_t stream) {
  const int ld = d | 1;  // an odd stride: 32 lanes on 32 centroids hit 32 banks
  const int kc = std::max(1, std::min(k, kChunkFloats / (ld + 1)));
  const size_t smem = (size_t)kc * (ld + 1) * sizeof(float);
  const int blocks = (n + kAssignWarps - 1) / kAssignWarps;
  kmeans_assign_kernel<MAXD><<<blocks, kAssignWarps * 32, smem, stream>>>(
      x, c, assign, dist, n, k, d, ld, kc);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// k-means++ seeding (kmeanspp_seed_f32)
// ---------------------------------------------------------------------------

constexpr float kFar = 1e15f;              // unused slots, as ref.FAR
constexpr int kSeedThreads = 512;      // x in shared memory: at most 16 rows a thread
constexpr int kSeedL2Threads = 1024;   // x from L2
constexpr int kSeedMaxRows = 16;       // rows a thread holds in registers
constexpr int kSeedMaxD = 16;
constexpr size_t kSeedSmemMax = 232448 - 1024;  // opt-in limit, less static smem

// The first row of the block's largest d2 (d2 >= 0), returned to every
// thread. Each thread passes its best (d2, row), or row INT_MAX if it has
// none. A non-negative float orders as its bits do, so a warp takes the
// largest bits and then the smallest row among the lanes that hold them
// (__reduce_max_sync, __reduce_min_sync); after one barrier every warp
// does the same over the warps' results. The results alternate between
// two buffers by `parity`, so the next pick's writes cannot meet this
// pick's reads, and one barrier a pick is enough.
__device__ __forceinline__ int block_argmax(float v, int i, int parity) {
  __shared__ unsigned red_v[2][32];
  __shared__ int red_i[2][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned vb = i == INT_MAX ? 0u : (__float_as_uint(v) & 0x7fffffffu);  // -0 as +0
  unsigned top = __reduce_max_sync(0xffffffffu, vb);
  i = __reduce_min_sync(0xffffffffu, vb == top ? i : INT_MAX);
  if (lane == 0) {
    red_v[parity][warp] = top;
    red_i[parity][warp] = i;
  }
  __syncthreads();
  const bool have = lane < (int)(blockDim.x / 32);
  vb = have ? red_v[parity][lane] : 0u;
  i = have ? red_i[parity][lane] : INT_MAX;
  top = __reduce_max_sync(0xffffffffu, vb);
  return __reduce_min_sync(0xffffffffu, vb == top ? i : INT_MAX);
}

// fills the slots past min(k, k_pad) -> the number of picks
__device__ __forceinline__ int seed_tail(float* cents, int* picks, int d, int k, int k_pad) {
  const int kk = max(0, min(k, k_pad));
  for (int i = threadIdx.x; i < (k_pad - kk) * d; i += blockDim.x)
    cents[(long long)kk * d + i] = kFar;
  for (int i = kk + threadIdx.x; i < k_pad; i += blockDim.x) picks[i] = -1;
  return kk;
}

// sum of squares of a row, as kmeans_assign_kernel's x2 and c2
template <int MAXD>
__device__ __forceinline__ float row_x2(const float* r, int d) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < MAXD; ++j)
    if (j < d) s = fmaf(r[j], r[j], s);
  return s;
}

// max(x2 - 2*dot + c2, 0), the one-centroid kmeans_assign distance
template <int MAXD>
__device__ __forceinline__ float one_d2(const float* r, float x2, const float (&c)[MAXD],
                                        float c2, int d) {
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < MAXD; ++j)
    if (j < d) dot = fmaf(r[j], c[j], dot);
  return fmaxf(__fadd_rn(__fsub_rn(x2, __fmul_rn(2.f, dot)), c2), 0.f);
}

// x in shared memory, R rows a thread (tid + r * blockDim.x) with their
// running d2 in registers; the seeding of one lane by one block, shared
// by kmeanspp_smem_kernel (one lane) and kmeanspp_smem_lanes_kernel (a
// lane a block)
template <int R>
__device__ __forceinline__ void kmeanspp_smem_body(const float* __restrict__ x,
                                                   float* __restrict__ cents,
                                                   int* __restrict__ picks, int n, int d,
                                                   int first, int k, int k_pad) {
  extern __shared__ float smem[];
  float* xs = smem;          // (n, d)
  float* x2s = smem + n * d;  // (n,)
  const int tid = threadIdx.x, nt = blockDim.x;
  const int kk = seed_tail(cents, picks, d, k, k_pad);
  if (kk == 0) return;
  for (int i = tid; i < n * d; i += nt) xs[i] = x[i];
  __syncthreads();
  for (int r = tid; r < n; r += nt) x2s[r] = row_x2<kSeedMaxD>(xs + r * d, d);
  __syncthreads();

  float d2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) d2[r] = INFINITY;
  int nxt = first;
  for (int i = 0;; ++i) {
    if (tid < d) cents[(long long)i * d + tid] = xs[nxt * d + tid];
    if (tid == 0) picks[i] = nxt;
    if (i + 1 >= kk) break;
    float c[kSeedMaxD];
#pragma unroll
    for (int j = 0; j < kSeedMaxD; ++j) c[j] = j < d ? xs[nxt * d + j] : 0.f;
    const float c2 = x2s[nxt];
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = tid + r * nt;
      if (row < n) {
        d2[r] = fminf(d2[r], one_d2<kSeedMaxD>(xs + row * d, x2s[row], c, c2, d));
        if (d2[r] > bv) {
          bv = d2[r];
          bi = row;
        }
      }
    }
    nxt = block_argmax(bv, bi, i & 1);
  }
}

template <int R>
__global__ void __launch_bounds__(kSeedThreads)
kmeanspp_smem_kernel(const float* __restrict__ x, float* __restrict__ cents,
                     int* __restrict__ picks, int n, int d, int first, int k, int k_pad) {
  kmeanspp_smem_body<R>(x, cents, picks, n, d, first, k, k_pad);
}

// x read from L2 each pick, d2 in the scratch buffer (each thread reads
// and writes only its own rows); shared by kmeanspp_l2_kernel and
// kmeanspp_l2_lanes_kernel as the shared-memory body is
__device__ __forceinline__ void kmeanspp_l2_body(const float* __restrict__ x,
                                                 float* __restrict__ cents,
                                                 int* __restrict__ picks,
                                                 float* __restrict__ d2g, int n, int d,
                                                 int first, int k, int k_pad) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int kk = seed_tail(cents, picks, d, k, k_pad);
  if (kk == 0) return;
  for (int r = tid; r < n; r += nt) d2g[r] = INFINITY;
  int nxt = first;
  for (int i = 0;; ++i) {
    const float* xc = x + (long long)nxt * d;
    if (tid < d) cents[(long long)i * d + tid] = xc[tid];
    if (tid == 0) picks[i] = nxt;
    if (i + 1 >= kk) break;
    float c[kSeedMaxD];
#pragma unroll
    for (int j = 0; j < kSeedMaxD; ++j) c[j] = j < d ? __ldg(xc + j) : 0.f;
    const float c2 = row_x2<kSeedMaxD>(c, d);
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int row = tid; row < n; row += nt) {
      float xr[kSeedMaxD];
#pragma unroll
      for (int j = 0; j < kSeedMaxD; ++j) xr[j] = j < d ? __ldg(x + (long long)row * d + j) : 0.f;
      const float v = fminf(d2g[row], one_d2<kSeedMaxD>(xr, row_x2<kSeedMaxD>(xr, d), c, c2, d));
      d2g[row] = v;
      if (v > bv) {
        bv = v;
        bi = row;
      }
    }
    nxt = block_argmax(bv, bi, i & 1);
  }
}

__global__ void __launch_bounds__(kSeedL2Threads)
kmeanspp_l2_kernel(const float* __restrict__ x, float* __restrict__ cents,
                   int* __restrict__ picks, float* __restrict__ d2g, int n, int d, int first,
                   int k, int k_pad) {
  kmeanspp_l2_body(x, cents, picks, d2g, n, d, first, k, k_pad);
}

// ---------------------------------------------------------------------------
// lane entries (kmeans_assign_lanes_f32, kmeanspp_seed_lanes_f32): the
// same work for L independent dedup lanes of one (n_pad, k_pad) bucket in
// one launch, lane l's rows at x + l * n * d
// ---------------------------------------------------------------------------

// kmeans_assign_kernel with the lane taken from blockIdx.y: one warp a row,
// the same table staging, arithmetic and lexicographic shuffle minimum, so
// lane l equals kmeans_assign_f32 on (x[l], c[l]) bit for bit
template <int MAXD>
__global__ void __launch_bounds__(kAssignWarps * 32)
kmeans_assign_lanes_kernel(const float* __restrict__ x, const float* __restrict__ c,
                           int* __restrict__ assign, float* __restrict__ dist, int n, int k,
                           int d, int ld, int kc) {
  extern __shared__ float smem[];
  float* cs = smem;             // (kc, ld) centroids of this chunk, ld = d | 1
  float* c2s = smem + kc * ld;  // (kc,) their sums of squares
  const long long lane_id = blockIdx.y;
  x += lane_id * n * d;
  c += lane_id * k * d;
  assign += lane_id * n;
  dist += lane_id * n;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kAssignWarps + threadIdx.x / 32;
  const bool live = row < n;  // the same for the whole warp

  float xr[MAXD];
  float x2 = 0.f;
#pragma unroll
  for (int j = 0; j < MAXD; ++j) {
    xr[j] = (live && j < d) ? x[(long long)row * d + j] : 0.f;
    x2 = fmaf(xr[j], xr[j], x2);
  }

  float best = INFINITY;
  int best_j = INT_MAX;  // none yet
  for (int k0 = 0; k0 < k; k0 += kc) {
    const int rows = min(kc, k - k0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
      __pipeline_memcpy_async(cs + (i / d) * ld + i % d, c + (long long)k0 * d + i,
                              sizeof(float));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      float s = 0.f;
      for (int j = 0; j < d; ++j) s = fmaf(cs[i * ld + j], cs[i * ld + j], s);
      c2s[i] = s;
    }
    __syncthreads();
    if (live) {
      for (int i = lane; i < rows; i += 32) {
        const float* ci = cs + i * ld;
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
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oj = __shfl_xor_sync(0xffffffffu, best_j, off);
    if (ov < best || (!(best < ov) && oj < best_j)) {
      best = ov;
      best_j = oj;
    }
  }
  if (live && lane == 0) {
    assign[row] = best_j == INT_MAX ? 0 : best_j;
    dist[row] = fmaxf(best, 0.f);
  }
}

template <int MAXD>
int launch_lanes(const float* x, const float* c, int* assign, float* dist, int lanes, int n,
                 int k, int d, cudaStream_t stream) {
  const int ld = d | 1;
  const int kc = std::max(1, std::min(k, kChunkFloats / (ld + 1)));
  const size_t smem = (size_t)kc * (ld + 1) * sizeof(float);
  const dim3 grid((n + kAssignWarps - 1) / kAssignWarps, lanes);
  kmeans_assign_lanes_kernel<MAXD><<<grid, kAssignWarps * 32, smem, stream>>>(
      x, c, assign, dist, n, k, d, ld, kc);
  return (int)cudaGetLastError();
}

// the seeding, a lane a block: each block runs the one-lane body on its
// lane's rows with that lane's n, first and k. The block size, rows a
// thread and shared memory follow n_pad (every lane's bound); the pick
// sequence does not depend on them (see block_argmax), so lane l equals
// kmeanspp_seed_f32 on (x[l], n[l], first[l], k[l]) bit for bit
template <int R>
__global__ void __launch_bounds__(kSeedThreads)
kmeanspp_smem_lanes_kernel(const float* __restrict__ x, float* __restrict__ cents,
                           int* __restrict__ picks, const int* __restrict__ lane_args,
                           int lanes, int n_pad, int d, int k_pad) {
  const int l = blockIdx.x;
  kmeanspp_smem_body<R>(x + (long long)l * n_pad * d, cents + (long long)l * k_pad * d,
                        picks + (long long)l * k_pad, lane_args[l], d,
                        lane_args[lanes + l], lane_args[2 * lanes + l], k_pad);
}

__global__ void __launch_bounds__(kSeedL2Threads)
kmeanspp_l2_lanes_kernel(const float* __restrict__ x, float* __restrict__ cents,
                         int* __restrict__ picks, float* __restrict__ d2g,
                         const int* __restrict__ lane_args, int lanes, int n_pad, int d,
                         int k_pad) {
  const int l = blockIdx.x;
  kmeanspp_l2_body(x + (long long)l * n_pad * d, cents + (long long)l * k_pad * d,
                   picks + (long long)l * k_pad, d2g + (long long)l * n_pad, lane_args[l], d,
                   lane_args[lanes + l], lane_args[2 * lanes + l], k_pad);
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
  if (d <= 16) return launch<16>(xf, cf, (int*)assign, (float*)dist, n, k, d, s);
  if (d <= 128) return launch<128>(xf, cf, (int*)assign, (float*)dist, n, k, d, s);
  return (int)cudaErrorInvalidValue;
}

// x: (n_pad, d) float32 contiguous with the real rows in [:n]; cents:
// (k_pad, d) float32; picks: (k_pad,) int32; scratch: (n,) float32, used
// only when x does not fit in shared memory. Requires 1 <= n, 1 <= d <=
// 16, 0 <= first < n, k_pad >= 0. One block. Returns cudaGetLastError()
// (or cudaErrorInvalidValue for arguments it refuses).
extern "C" int kmeanspp_seed_f32(const void* x, void* cents, void* picks, void* scratch, int n,
                                 int d, int first, int k, int k_pad, void* stream) {
  if (n < 1 || d < 1 || d > kSeedMaxD || first < 0 || first >= n || k_pad < 0)
    return (int)cudaErrorInvalidValue;
  if (k_pad == 0) return (int)cudaGetLastError();
  const float* xf = (const float*)x;
  float* cf = (float*)cents;
  int* pi = (int*)picks;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = std::min(kSeedThreads, (n + 31) / 32 * 32);
  const int rows = (n + threads - 1) / threads;
  const size_t smem = (size_t)n * (d + 1) * sizeof(float);
  if (rows <= kSeedMaxRows && smem <= kSeedSmemMax) {
    void (*kernel)(const float*, float*, int*, int, int, int, int, int) =
        rows == 1   ? kmeanspp_smem_kernel<1>
        : rows == 2 ? kmeanspp_smem_kernel<2>
        : rows <= 4 ? kmeanspp_smem_kernel<4>
        : rows <= 8 ? kmeanspp_smem_kernel<8>
                    : kmeanspp_smem_kernel<16>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<1, threads, smem, s>>>(xf, cf, pi, n, d, first, k, k_pad);
  } else {
    kmeanspp_l2_kernel<<<1, kSeedL2Threads, 0, s>>>(xf, cf, pi, (float*)scratch, n, d, first, k,
                                                  k_pad);
  }
  return (int)cudaGetLastError();
}

// x: (lanes, n, d) float32 and c: (lanes, k, d) float32, both contiguous;
// assign: (lanes, n) int32; dist: (lanes, n) float32. Requires lanes in
// [1, 65535], n >= 1, k >= 1 and 1 <= d <= 128. Returns cudaGetLastError().
extern "C" int kmeans_assign_lanes_f32(const void* x, const void* c, void* assign, void* dist,
                                       int lanes, int n, int k, int d, void* stream) {
  if (lanes < 1 || lanes > 65535 || n < 1 || k < 1 || d < 1 || d > 128)
    return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  const float* cf = (const float*)c;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 16) return launch_lanes<16>(xf, cf, (int*)assign, (float*)dist, lanes, n, k, d, s);
  return launch_lanes<128>(xf, cf, (int*)assign, (float*)dist, lanes, n, k, d, s);
}

// x: (lanes, n_pad, d) float32 contiguous, lane l's real rows in
// [:n[l]]; lane_args: (3, lanes) int32 on the device, the rows n, first
// picks and k of every lane (1 <= n <= n_pad, 0 <= first < n, k >= 0;
// the caller checks them); cents: (lanes, k_pad, d) float32; picks:
// (lanes, k_pad) int32; scratch: (lanes, n_pad) float32, used only when
// x does not fit in shared memory. Requires 1 <= d <= 16, k_pad >= 0.
// One block a lane. Returns cudaGetLastError() (or cudaErrorInvalidValue
// for arguments it refuses).
extern "C" int kmeanspp_seed_lanes_f32(const void* x, void* cents, void* picks, void* scratch,
                                       const void* lane_args, int lanes, int n_pad, int d,
                                       int k_pad, void* stream) {
  if (lanes < 1 || n_pad < 1 || d < 1 || d > kSeedMaxD || k_pad < 0)
    return (int)cudaErrorInvalidValue;
  if (k_pad == 0) return (int)cudaGetLastError();
  const float* xf = (const float*)x;
  float* cf = (float*)cents;
  int* pi = (int*)picks;
  const int* args = (const int*)lane_args;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = std::min(kSeedThreads, (n_pad + 31) / 32 * 32);
  const int rows = (n_pad + threads - 1) / threads;
  const size_t smem = (size_t)n_pad * (d + 1) * sizeof(float);
  if (rows <= kSeedMaxRows && smem <= kSeedSmemMax) {
    void (*kernel)(const float*, float*, int*, const int*, int, int, int, int) =
        rows == 1   ? kmeanspp_smem_lanes_kernel<1>
        : rows == 2 ? kmeanspp_smem_lanes_kernel<2>
        : rows <= 4 ? kmeanspp_smem_lanes_kernel<4>
        : rows <= 8 ? kmeanspp_smem_lanes_kernel<8>
                    : kmeanspp_smem_lanes_kernel<16>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<lanes, threads, smem, s>>>(xf, cf, pi, args, lanes, n_pad, d, k_pad);
  } else {
    kmeanspp_l2_lanes_kernel<<<lanes, kSeedL2Threads, 0, s>>>(xf, cf, pi, (float*)scratch, args,
                                                            lanes, n_pad, d, k_pad);
  }
  return (int)cudaGetLastError();
}
