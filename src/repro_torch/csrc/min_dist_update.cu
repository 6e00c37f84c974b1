// One step of the k-median++ / k-means++ seeding's running minimum, for
// Hopper (sm_90a).
//
// Replaces: no TPU kernel.  The reference's seeding (src/repro/core/kmeans.py)
// recomputes each point's distance to all k center slots through the
// nearest-center kernel at every one of its k - 1 steps, though only one
// center is new in each.  Ported as it is, that loop was ~90% of a resilient
// solve's device time at k = 1024 on this card.  This kernel carries each
// point's squared distance to the nearest chosen center from step to step
// and folds in the one new center, so a step reads the points once.
//
// Computes, per batch b, for x (B, n, d), c (B, d) (rows c_stride floats
// apart), d2 (B, n) updated in place and w (B, n):
//     d2[b, i]     = min(d2[b, i], sum_j (x[b, i, j] - c[b, j])^2)
//     logits[b, i] = w > 0 ? log(max(w * s, 1e-12)) : -inf,
//                    s = sqrt(max(d2[b, i], 0)) if median else d2[b, i]
// in fp32: the direct difference, so a point equal to the center reads 0,
// accumulated with fp32 FMAs; no TF32, no bf16.
//
// Bound: the bytes.  x read once, the center once, d2 read and written, w
// read and the logits written: 4 * (B*n*d + B*d + 4*B*n) bytes over
// 3.35 TB/s (0.63 ms at the local solve's (10, 400000, 128)); the 3*B*n*d
// operations (a difference and an FMA an element) are far below the fp32
// peak.
//
// Design.  One wave of blocks, as many as the card holds at once, split over
// the batches; a block stages its batch's center in shared memory once and
// walks rows in a grid-stride loop.  A warp takes R rows at a time: its 32
// lanes read neighbouring 16-byte units of a row (neighbouring floats on the
// scalar path), so each load instruction of the warp reads one contiguous
// span, and each lane keeps the R rows' loads in flight before it computes.
// x is read with ld.global.cs (evict-first in L1 and L2): it is read once a
// step and is ~40x the L2; d2, w and the logits (the sampling reads them
// next) keep the default policy.  The lanes reduce each row's partial sums
// with shuffles, and lane r writes row r's d2 and logit, having loaded its d2
// and w before the rows' x.  Every row is summed in one fixed order whatever
// B and the grid are, so a row's result does not depend on the batch it came
// in (the mesh's node blocks rely on that).  The 16-byte path is taken where
// d % 4 == 0 and every row of x and c starts 16-byte aligned; any other d
// takes the 4-byte path of the same kernel.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int R = 4;              // rows of a warp in flight
constexpr float FLOOR = 1e-12f;   // pairwise_dist/ref.py's SCORE_FLOOR

template <bool VEC>
__global__ void __launch_bounds__(THREADS) min_dist_update_kernel(
    const float* __restrict__ x, const float* __restrict__ c, float* __restrict__ d2,
    const float* __restrict__ w, float* __restrict__ logits, int n, int d, long long c_stride,
    int median) {
  extern __shared__ float4 c_s4[];  // the center: d floats
  float* c_s = reinterpret_cast<float*>(c_s4);
  const int b = blockIdx.y;
  const float* cb = c + (long long)b * c_stride;
  for (int j = threadIdx.x; j < d; j += THREADS) c_s[j] = cb[j];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int units = VEC ? d / 4 : d;
  const long long base = (long long)b * n;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const long long stride = (long long)gridDim.x * WARPS * R;

  for (long long row0 = ((long long)blockIdx.x * WARPS + warp) * R; row0 < n; row0 += stride) {
    // Lane r owns row row0 + r: its d2 and w first.
    const long long mine = row0 + lane;
    const bool owner = lane < R && mine < n;
    float old = 0.f, wi = 0.f;
    if (owner) {
      old = d2[base + mine];
      wi = w[base + mine];
    }
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int j = lane; j < units; j += 32) {
      if constexpr (VEC) {
        const float4 cv = c_s4[j];
        float4 xv[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const long long row = row0 + r;
          xv[r] = row < n ? __ldcs(x4 + (base + row) * units + j) : cv;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float t = xv[r].x - cv.x;
          acc[r] = fmaf(t, t, acc[r]);
          t = xv[r].y - cv.y;
          acc[r] = fmaf(t, t, acc[r]);
          t = xv[r].z - cv.z;
          acc[r] = fmaf(t, t, acc[r]);
          t = xv[r].w - cv.w;
          acc[r] = fmaf(t, t, acc[r]);
        }
      } else {
        const float cv = c_s[j];
        float xv[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const long long row = row0 + r;
          xv[r] = row < n ? __ldcs(x + (base + row) * d + j) : cv;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float t = xv[r] - cv;
          acc[r] = fmaf(t, t, acc[r]);
        }
      }
    }
    // The lanes sum their partials; every lane ends with each row's sum.
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
    float dist = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) dist = lane == r ? acc[r] : dist;
    if (owner) {
      const float nd = fminf(old, dist);
      d2[base + mine] = nd;
      const float score = median ? sqrtf(fmaxf(nd, 0.f)) : nd;
      logits[base + mine] = wi > 0.f ? logf(fmaxf(wi * score, FLOOR)) : -__int_as_float(0x7f800000);
    }
  }
}

template <bool VEC>
cudaError_t launch(const float* x, const float* c, float* d2, const float* w, float* logits, int B,
                   int n, int d, long long c_stride, int median, cudaStream_t stream) {
  // One wave of blocks: as many as the card holds at once, split over the
  // batches (a second, partial wave would leave most SMs idle at its end).
  const size_t smem = (size_t)((d + 3) / 4) * sizeof(float4);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, min_dist_update_kernel<VEC>, THREADS,
                                                        smem);
  if (err != cudaSuccess) return err;
  const long long rows_per_block = (long long)WARPS * R;
  const long long need = (n + rows_per_block - 1) / rows_per_block;
  long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1) / B;
  if (fit < 1) fit = 1;
  const dim3 grid((unsigned)(need < fit ? need : fit), (unsigned)B);
  min_dist_update_kernel<VEC><<<grid, THREADS, smem, stream>>>(x, c, d2, w, logits, n, d, c_stride,
                                                               median);
  return cudaGetLastError();
}

}  // namespace

// x (B, n, d), c (B, d) with rows c_stride floats apart, d2, w, logits (B, n),
// all fp32 device pointers; vec != 0 only where d % 4 == 0 and x, c and
// c_stride keep every row 16-byte aligned.  Launches on `stream` without
// synchronising; returns the launch's cudaError_t (0 on success).
extern "C" int min_dist_update_launch(const float* x, const float* c, float* d2, const float* w,
                                      float* logits, int B, int n, int d, long long c_stride,
                                      int median, int vec, cudaStream_t stream) {
  if (B <= 0 || n <= 0 || d <= 0) return 0;
  const cudaError_t err =
      vec ? launch<true>(x, c, d2, w, logits, B, n, d, c_stride, median, stream)
          : launch<false>(x, c, d2, w, logits, B, n, d, c_stride, median, stream);
  return (int)err;
}
