// Fused nearest-center assignment for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces: src/repro/kernels/pairwise_dist/kernel.py `_assign_kernel` via
// `assign_min_kernel_call` (the Pallas TPU kernel).
//
// Computes, for each batch b and row i of x (B, n, d) against the centers
// c (B, k, d):
//     d2[j] = max(|x_i|^2 + |c_j|^2 - 2 x_i.c_j, 0)   for j < k_valid
//     idx[b, i] = first j with the least d2,  dist[b, i] = that d2
// The (n, k) matrix never reaches device memory.  Columns >= k_valid are
// skipped by index (never by padding coordinates: huge pad coordinates
// overflow |c|^2 and give inf - inf = NaN).  With no valid column the
// result is idx 0 and dist PAD_DIST, as in the Pallas kernel.
//
// Bound: 2*B*n*k*d floating-point operations against the H100's 67 TFLOP/s
// fp32 (non-tensor-core) peak; the bytes (x and c once, idx and dist once)
// are far below the memory roofline at the shapes of Algorithm 1.  This
// first version keeps the dot products in fp32 FMA on the CUDA cores (no
// tensor cores, no TF32, so the argmin sees full fp32 distances).  Each
// block holds a 64x64 (rows x centers) tile in registers, 4x4 per thread,
// and stages x and c in 32-wide chunks of d through shared memory.  The
// norms |c_j|^2 (every center tile) and |x_i|^2 (first center tile) are
// summed from the same staged chunks, so one launch does the whole call.
// wgmma / TMA / 3xTF32 are later work.
//
// Tie rule: every thread walks its centers in increasing order with a
// strict '<' (clamped at 0 BEFORE comparing, so two centers that both clamp
// to 0 tie), and the 16 threads that share a row reduce with a
// lexicographic (dist, idx) min, so ties resolve to the earliest index,
// exactly as jnp.argmin / torch.argmin.  k-median++ seeding evaluates exact
// duplicate centers on every step, so this rule matters.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;        // rows of x per block
constexpr int TN = 64;        // centers per tile
constexpr int DK = 32;        // chunk of d staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr float PAD_DIST = 3.4e38f;

__global__ void __launch_bounds__(THREADS)
assign_min_kernel(const float* __restrict__ x, const float* __restrict__ c,
                  int32_t* __restrict__ idx_out, float* __restrict__ dist_out,
                  int n, int k, int d, int kv) {
  // +1 column of padding: the transposed stores hit 32 distinct banks.
  __shared__ float xs[DK][TM + 1];
  __shared__ float cs[DK][TN + 1];
  __shared__ float xn_s[TM];  // |x_r|^2 of the block's rows
  __shared__ float cn_s[TN];  // |c_j|^2 of the current center tile

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // center lane: centers tx + 16*j of a tile
  const int ty = tid / 16;  // row lane: rows ty + 16*i of the block
  const float* xb = x + (long long)b * n * d;
  const float* cb = c + (long long)b * k * d;

  float xn[4], best[4];
  int besti[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    xn[i] = 0.f;
    best[i] = PAD_DIST;
    besti[i] = 0;
  }

  // Norms, spread over all threads: thread tid sums DK/4 of each staged
  // chunk's entries of center tid/4 (and, on the first tile, of row tid/4);
  // the 4 neighbouring lanes of one center combine by shuffles.  Padded
  // entries are staged as 0 and add nothing.
  static_assert(TM == THREADS / 4 && TN == THREADS / 4, "one norm per 4 threads");
  const int nrow = tid / 4;
  const int npart = (tid % 4) * (DK / 4);
  float xpart = 0.f;
  for (int col0 = 0; col0 < kv; col0 += TN) {
    float cpart = 0.f;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += DK) {
      // 32 neighbouring threads read 32 neighbouring floats of one row.
      for (int e = tid; e < TM * DK; e += THREADS) {
        const int r = e / DK, cc = e % DK;
        const int gr = row0 + r, gc = k0 + cc;
        xs[cc][r] = (gr < n && gc < d) ? xb[(long long)gr * d + gc] : 0.f;
      }
      for (int e = tid; e < TN * DK; e += THREADS) {
        const int r = e / DK, cc = e % DK;
        const int gk = col0 + r, gc = k0 + cc;
        cs[cc][r] = (gk < kv && gc < d) ? cb[(long long)gk * d + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < DK / 4; ++q) {
        const float v = cs[npart + q][nrow];
        cpart = fmaf(v, v, cpart);
      }
      if (col0 == 0) {
#pragma unroll
        for (int q = 0; q < DK / 4; ++q) {
          const float v = xs[npart + q][nrow];
          xpart = fmaf(v, v, xpart);
        }
      }
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = cs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
    cpart += __shfl_xor_sync(0xffffffffu, cpart, 1);
    cpart += __shfl_xor_sync(0xffffffffu, cpart, 2);
    if (tid % 4 == 0) cn_s[nrow] = cpart;
    if (col0 == 0) {
      xpart += __shfl_xor_sync(0xffffffffu, xpart, 1);
      xpart += __shfl_xor_sync(0xffffffffu, xpart, 2);
      if (tid % 4 == 0) xn_s[nrow] = xpart;
    }
    __syncthreads();
    if (col0 == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) xn[i] = xn_s[ty + 16 * i];
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < kv) {
        const float cn = cn_s[tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float d2 = fmaxf(xn[i] + cn - 2.f * acc[i][j], 0.f);
          if (d2 < best[i]) {
            best[i] = d2;
            besti[i] = col;
          }
        }
      }
    }
    __syncthreads();  // cn_s is rewritten by the next tile
  }

  // The 16 threads of a row are the lanes of one half-warp (tid = 16*ty + tx).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float bd = best[i];
    int bi = besti[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (od < bd || (od == bd && oi < bi)) {
        bd = od;
        bi = oi;
      }
    }
    const int r = row0 + ty + 16 * i;
    if (tx == 0 && r < n) {
      idx_out[(long long)b * n + r] = bi;
      dist_out[(long long)b * n + r] = bd;
    }
  }
}

}  // namespace

// x (B, n, d), c (B, k, d) fp32 contiguous; idx (B, n) int32 and dist (B, n)
// fp32 out.  Launches on `stream`, does not synchronise, allocates nothing;
// returns cudaGetLastError() of the launch.
extern "C" int assign_min_launch(const float* x, const float* c, int32_t* idx, float* dist,
                                 int B, int n, int k, int d, int k_valid, void* stream) {
  if (B <= 0 || n <= 0 || d <= 0 || k < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const int kv = k_valid < k ? (k_valid < 0 ? 0 : k_valid) : k;
  dim3 grid((n + TM - 1) / TM, B);
  assign_min_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, c, idx, dist, n, k, d, kv);
  return (int)cudaGetLastError();
}
