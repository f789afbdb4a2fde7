// Pairwise IoU of xyxy boxes and the detector's greedy NMS, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/iou.py (iou_matrix, _kernel)
// and the greedy suppression its caller runs over the matrix
// (repro/models/detector.py, nms_keep's lax.fori_loop). Two entries:
//
// - iou_matrix_f32: for boxes a (B, N, 4) and b (B, M, 4), out (B, N, M)
//   = inter / max(union, 1e-9), with box areas clamped at 0. The
//   unbatched call is B = 1. Bound: memory, by the output write
//   (B*N*M*4 bytes; the inputs are 16 bytes a box); each output costs
//   about a dozen flops. A block computes a 32 x 32 tile of one batch's
//   output: its 32 row and 32 column boxes, with their areas, are staged
//   in shared memory once, and a thread walks rows of its column, so each
//   warp writes 32 neighbouring floats (coalesced).
//
// - nms_keep_f32: the whole NMS of a counting batch in one launch, one
//   CTA an image. From the image's boxes and its top-k candidates (the
//   indices and scores of a stable descending sort, first k of each row),
//   the CTA gathers the k boxes into shared memory, builds the overlap
//   bitmask (row i, bit j: iou(i, j) > iou_thr and j > i; one warp a
//   row, each lane one column of a 32-column word, the word from
//   __ballot_sync),
//   walks the kept candidates in order on one warp (keep &= ~mask[i] at
//   each, __ffs over the keep words), and scatters the keep flags to the
//   image's (N,) byte mask. The IoU matrix never reaches device memory.
//   Bound: latency. The bytes (k boxes, indices and scores read, N bytes
//   written) and the IoUs take well under a microsecond on the card; the
//   scan is a chain of dependent steps, one a kept box.
//
// Both entries share one IoU function. Every rounding step is an explicit
// IEEE intrinsic (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn), so nothing
// is contracted into an FMA, and min and max return NaN when either
// operand is NaN, as torch.minimum, torch.maximum and torch.clamp do
// (fminf and fmaxf return the other operand): the IoU equals the plain
// PyTorch version bit for bit, NaN boxes included, and a NaN IoU
// suppresses nothing, as in the reference.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;  // iou_matrix_f32: blockDim = (32, 8)
constexpr int kNmsThreads = 256;
constexpr int kMaxK = 1024;           // nms_keep_f32: candidates an image
constexpr int kMaxWords = kMaxK / 32; // keep words, one a lane of the scan warp
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(max_nan(__fsub_rn(x2, x1), 0.f), max_nan(__fsub_rn(y2, y1), 0.f));
}

// The plain version's order: ix, iy, inter, area_a + area_b - inter, and
// inter / max(union, 1e-9).
__device__ __forceinline__ float box_iou(float ax1, float ay1, float ax2, float ay2,
                                         float area_a, float bx1, float by1, float bx2,
                                         float by2, float area_b) {
  const float ix = max_nan(__fsub_rn(min_nan(ax2, bx2), max_nan(ax1, bx1)), 0.f);
  const float iy = max_nan(__fsub_rn(min_nan(ay2, by2), max_nan(ay1, by1)), 0.f);
  const float inter = __fmul_rn(ix, iy);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, max_nan(uni, 1e-9f));
}

__global__ void iou_kernel(const float* __restrict__ a, const float* __restrict__ b,
                           float* __restrict__ out, int n, int m) {
  const long long batch = blockIdx.z;
  const float* ab = a + batch * n * 4;
  const float* bb = b + batch * m * 4;
  float* ob = out + batch * n * m;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;

  __shared__ float sa[kTile][5];  // x1 y1 x2 y2 area
  __shared__ float sb[kTile][5];
  const int tid = threadIdx.y * kTile + threadIdx.x;
  if (tid < kTile) {
    const int i = i0 + tid;
    if (i < n) {
      const float4 v = *reinterpret_cast<const float4*>(ab + 4LL * i);
      sa[tid][0] = v.x; sa[tid][1] = v.y; sa[tid][2] = v.z; sa[tid][3] = v.w;
      sa[tid][4] = box_area(v.x, v.y, v.z, v.w);
    }
  } else if (tid < 2 * kTile) {
    const int r = tid - kTile, j = j0 + r;
    if (j < m) {
      const float4 v = *reinterpret_cast<const float4*>(bb + 4LL * j);
      sb[r][0] = v.x; sb[r][1] = v.y; sb[r][2] = v.z; sb[r][3] = v.w;
      sb[r][4] = box_area(v.x, v.y, v.z, v.w);
    }
  }
  __syncthreads();

  const int tx = threadIdx.x, j = j0 + tx;
  if (j >= m) return;
  const float bx1 = sb[tx][0], by1 = sb[tx][1], bx2 = sb[tx][2], by2 = sb[tx][3];
  const float area_b = sb[tx][4];
  for (int r = threadIdx.y; r < kTile && i0 + r < n; r += kRowsPerPass) {
    ob[(long long)(i0 + r) * m + j] = box_iou(sa[r][0], sa[r][1], sa[r][2], sa[r][3], sa[r][4],
                                              bx1, by1, bx2, by2, area_b);
  }
}

// One CTA an image. Dynamic shared memory: the k gathered boxes as five
// float arrays (x1, y1, x2, y2, area), their indices, and the overlap
// bitmask, k rows of `words` 32-bit words.
__global__ void __launch_bounds__(kNmsThreads)
nms_kernel(const float* __restrict__ boxes, const int64_t* __restrict__ top_i,
           const float* __restrict__ top_s, bool* __restrict__ keep_out, int n, int k,
           int ld, float iou_thr, float score_thr) {
  extern __shared__ float smem[];
  __shared__ uint32_t skeep[kMaxWords];
  const int words = (k + 31) / 32;
  float* sx1 = smem;
  float* sy1 = sx1 + k;
  float* sx2 = sy1 + k;
  float* sy2 = sx2 + k;
  float* sarea = sy2 + k;
  int* sidx = reinterpret_cast<int*>(sarea + k);
  uint32_t* smask = reinterpret_cast<uint32_t*>(sidx + k);

  const long long img = blockIdx.x;
  const float* bx = boxes + img * n * 4;
  const int64_t* ti = top_i + img * ld;
  const float* ts = top_s + img * ld;
  bool* out = keep_out + img * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kNmsThreads / 32;

  // the image's mask row to zero (its kept flags are written after the
  // last __syncthreads), the candidates' boxes gathered, the keep words
  // from the scores
  for (int t = tid; t < n; t += kNmsThreads) out[t] = false;
  for (int t = tid; t < k; t += kNmsThreads) {
    const int idx = (int)ti[t];
    const float4 v = *reinterpret_cast<const float4*>(bx + 4LL * idx);
    sx1[t] = v.x; sy1[t] = v.y; sx2[t] = v.z; sy2[t] = v.w;
    sarea[t] = box_area(v.x, v.y, v.z, v.w);
    sidx[t] = idx;
  }
  for (int w = warp; w < words; w += kWarps) {
    const int t = w * 32 + lane;
    const uint32_t bits = __ballot_sync(kFull, t < k && ts[t] > score_thr);
    if (lane == 0) skeep[w] = bits;
  }
  __syncthreads();

  // overlap bitmask, a warp a row. Only rows that start kept are ever
  // read, and of a row i only the words from i's own on (later columns).
  for (int i = warp; i < k; i += kWarps) {
    if (!((skeep[i >> 5] >> (i & 31)) & 1u)) continue;  // warp-uniform
    const float ax1 = sx1[i], ay1 = sy1[i], ax2 = sx2[i], ay2 = sy2[i], area = sarea[i];
    for (int w = i >> 5; w < words; ++w) {
      const int j = w * 32 + lane;
      bool over = false;
      if (j > i && j < k) {
        over = box_iou(ax1, ay1, ax2, ay2, area, sx1[j], sy1[j], sx2[j], sy2[j], sarea[j]) >
               iou_thr;
      }
      const uint32_t bits = __ballot_sync(kFull, over);
      if (lane == 0) smask[i * words + w] = bits;
    }
  }
  __syncthreads();

  // greedy scan on one warp, lane w holding keep word w: each kept
  // candidate i, in ascending order, clears the later candidates it
  // overlaps. Rows suppressed before their turn are skipped: the chain
  // is one step a kept box, and each step reads i's own word of the
  // mask by a broadcast load (no shuffle in the chain).
  if (warp == 0) {
    uint32_t kw = lane < words ? skeep[lane] : 0u;
    for (int w = 0; w < words; ++w) {
      uint32_t cur = __shfl_sync(kFull, kw, w);  // the word's candidates still kept
      while (cur) {
        const int bit = __ffs(cur) - 1;
        const uint32_t* row = smask + (w * 32 + bit) * words;
        if (lane >= w && lane < words) kw &= ~row[lane];
        cur &= ~row[w] & ~((2u << bit) - 1u);  // the kept ones after i
      }
    }
    if (lane < words) skeep[lane] = kw;
  }
  __syncthreads();

  for (int t = tid; t < k; t += kNmsThreads) out[sidx[t]] = (skeep[t >> 5] >> (t & 31)) & 1u;
}

}  // namespace

// a: (batch, n, 4), b: (batch, m, 4) float32, contiguous and 16-byte
// aligned; out: (batch, n, m) float32. Requires batch <= 65535 and
// n <= 65535 * 32. Returns cudaGetLastError().
extern "C" int iou_matrix_f32(const void* a, const void* b, void* out, int batch,
                              int n, int m, void* stream) {
  if (batch > 0 && n > 0 && m > 0) {
    const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile, batch);
    const dim3 block(kTile, kRowsPerPass);
    iou_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)b, (float*)out, n, m);
  }
  return (int)cudaGetLastError();
}

// boxes: (batch, n, 4) float32, contiguous and 16-byte aligned; top_i
// (int64, values in [0, n), distinct in a row) and top_s (float32): the
// first k of each row of a descending sort, row b at offset b * ld;
// keep: (batch, n) bool, every byte written. Requires 0 <= k <= min(n,
// 1024). Returns cudaGetLastError().
extern "C" int nms_keep_f32(const void* boxes, const void* top_i, const void* top_s,
                            void* keep, int batch, int n, int k, int ld, float iou_thr,
                            float score_thr, void* stream) {
  if (k < 0 || k > kMaxK || k > n) return (int)cudaErrorInvalidValue;
  if (batch > 0) {
    const int words = (k + 31) / 32;
    const size_t smem = (size_t)k * (5 * sizeof(float) + sizeof(int)) +
                        (size_t)k * words * sizeof(uint32_t);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    nms_kernel<<<batch, kNmsThreads, smem, (cudaStream_t)stream>>>(
        (const float*)boxes, (const int64_t*)top_i, (const float*)top_s, (bool*)keep, n, k,
        ld, iou_thr, score_thr);
  }
  return (int)cudaGetLastError();
}
