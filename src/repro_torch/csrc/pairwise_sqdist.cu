// Full squared-distance matrix for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces: src/repro/kernels/pairwise_dist/kernel.py `_sqdist_kernel` via
// `pairwise_sqdist_kernel_call` (the Pallas TPU kernel).
//
// Computes, for x (n, d) and c (k, d):
//     out[i, j] = max(|x_i|^2 + |c_j|^2 - 2 x_i.c_j, 0)        (n, k) fp32
// in the decomposition of the Pallas kernel's `_sqdist_block`.
//
// Bound: 2*n*k*d floating-point operations against the H100's 67 TFLOP/s
// fp32 (non-tensor-core) peak, and the bytes (x and c read once, the (n, k)
// output written once) against 3.35 TB/s.  At d = 128 the operations bound
// it as written (fp32 FMA); with TF32 or wgmma the output's bytes would.
// The tile scheme is assign_min.cu's: each block owns a 64x64 (rows x
// centers) tile of the output, 4x4 per thread in registers, and stages x
// and c in 32-wide chunks of d through shared memory; the norms are summed
// from the same staged chunks.  Instead of reducing the tile to an argmin,
// it writes the clamped tile: thread (ty, tx) holds rows ty + 16*i and
// columns tx + 16*j, so each warp store covers two rows of 16 neighbouring
// floats (two full 64-byte runs).  No TF32, no atomics: every output
// element is written by exactly one thread.
//
// Edges: rows >= n and columns >= k are staged as 0 and never stored; a
// ragged d is staged as 0 past its end.  The wrapper raises on d = 0 and
// skips the launch for n = 0 or k = 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;        // rows of x per block
constexpr int TN = 64;        // centers per block
constexpr int DK = 32;        // chunk of d staged in shared memory
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
pairwise_sqdist_kernel(const float* __restrict__ x, const float* __restrict__ c,
                       float* __restrict__ out, int n, int k, int d) {
  // +1 column of padding: the transposed stores hit 32 distinct banks.
  __shared__ float xs[DK][TM + 1];
  __shared__ float cs[DK][TN + 1];
  __shared__ float xn_s[TM];  // |x_r|^2 of the block's rows
  __shared__ float cn_s[TN];  // |c_j|^2 of the block's centers

  const int row0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // center lane: centers tx + 16*j of the tile
  const int ty = tid / 16;  // row lane: rows ty + 16*i of the tile

  // Norms, spread over all threads: thread tid sums DK/4 entries of each
  // staged chunk of row tid/4 and of center tid/4; the 4 neighbouring lanes
  // combine by shuffles.  Padded entries are staged as 0 and add nothing.
  static_assert(TM == THREADS / 4 && TN == THREADS / 4, "one norm per 4 threads");
  const int nrow = tid / 4;
  const int npart = (tid % 4) * (DK / 4);
  float xpart = 0.f, cpart = 0.f;

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
      xs[cc][r] = (gr < n && gc < d) ? x[(long long)gr * d + gc] : 0.f;
    }
    for (int e = tid; e < TN * DK; e += THREADS) {
      const int r = e / DK, cc = e % DK;
      const int gk = col0 + r, gc = k0 + cc;
      cs[cc][r] = (gk < k && gc < d) ? c[(long long)gk * d + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < DK / 4; ++q) {
      const float v = xs[npart + q][nrow];
      xpart = fmaf(v, v, xpart);
      const float u = cs[npart + q][nrow];
      cpart = fmaf(u, u, cpart);
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
  xpart += __shfl_xor_sync(0xffffffffu, xpart, 1);
  xpart += __shfl_xor_sync(0xffffffffu, xpart, 2);
  cpart += __shfl_xor_sync(0xffffffffu, cpart, 1);
  cpart += __shfl_xor_sync(0xffffffffu, cpart, 2);
  if (tid % 4 == 0) {
    xn_s[nrow] = xpart;
    cn_s[nrow] = cpart;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n) continue;
    const float xn = xn_s[ty + 16 * i];
    float* orow = out + (long long)r * k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < k) orow[col] = fmaxf(xn + cn_s[tx + 16 * j] - 2.f * acc[i][j], 0.f);
    }
  }
}

}  // namespace

// x (n, d), c (k, d) fp32 contiguous; out (n, k) fp32.  Launches on
// `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError() of the launch.
extern "C" int pairwise_sqdist_launch(const float* x, const float* c, float* out,
                                      int n, int k, int d, void* stream) {
  if (n <= 0 || k <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int col_tiles = (k + TN - 1) / TN;
  if (col_tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((n + TM - 1) / TM, col_tiles);
  pairwise_sqdist_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, c, out, n, k, d);
  return (int)cudaGetLastError();
}
