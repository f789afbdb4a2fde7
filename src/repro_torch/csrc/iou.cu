// Pairwise IoU of xyxy boxes, batched, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/iou.py (iou_matrix, _kernel):
// for boxes a (B, N, 4) and b (B, M, 4), out (B, N, M) =
// inter / max(union, 1e-9), with box areas clamped at 0. The unbatched
// call is B = 1.
//
// Bound: memory, by the output write (B*N*M*4 bytes; the inputs are
// 16 bytes a box). Each output costs about a dozen flops.
//
// Design: a block computes a 32 x 32 tile of one batch's output. Its 32
// row boxes and 32 column boxes, with their areas, are staged in shared
// memory once; a thread then walks rows of its column, so each warp
// writes 32 neighbouring floats (coalesced). Every rounding step is an
// explicit IEEE intrinsic (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn),
// so nothing is contracted into an FMA and the result equals the plain
// PyTorch version bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;  // blockDim = (32, 8)

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f), fmaxf(__fsub_rn(y2, y1), 0.f));
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
    const float ix = fmaxf(__fsub_rn(fminf(sa[r][2], bx2), fmaxf(sa[r][0], bx1)), 0.f);
    const float iy = fmaxf(__fsub_rn(fminf(sa[r][3], by2), fmaxf(sa[r][1], by1)), 0.f);
    const float inter = __fmul_rn(ix, iy);
    const float uni = __fsub_rn(__fadd_rn(sa[r][4], area_b), inter);
    ob[(long long)(i0 + r) * m + j] = __fdiv_rn(inter, fmaxf(uni, 1e-9f));
  }
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
