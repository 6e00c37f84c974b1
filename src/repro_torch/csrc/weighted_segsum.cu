// Deterministic weighted segment sum for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/weighted_segsum/kernel.py `_segsum_kernel` via
// `weighted_segsum_kernel_call` (the Pallas TPU kernel, a one-hot matmul
// because the TPU has no fast scatter).
//
// Computes, per batch b, for x (B, n, d), w (B, n), idx (B, n) int32:
//     sums[b, c, :] = sum_{i: idx_i = c} w_i * x_i     (B, k, d) fp32
//     totals[b, c]  = sum_{i: idx_i = c} w_i           (B, k)    fp32
// A row whose idx lies outside [0, k) adds nothing; padded rows carry w = 0.
//
// Bound: the bytes.  Each row is read once (d + 2 words) and the outputs are
// small, so the least time is B*n*(d+2)*4 bytes over 3.35 TB/s; the
// 2*B*n*(d+1) operations are far below the fp32 peak.
//
// Determinism: no float atomics anywhere.  The totals are treated as one
// more column (column d, whose "x" is 1), so the layout is (d+1) columns.
//   Pass 1: grid (row chunks, column chunks x k tiles, B).  A block is one
//     warp; each lane owns one column of a 32-wide column chunk and walks the
//     chunk's rows in order, adding w*x into a (k_tile, 32) accumulator in
//     shared memory, then writes it to the workspace (B, chunks, k, d+1).
//     Rows are prefetched 16 at a time into registers; the adds keep row
//     order, so the result is the same bits on every run.
//   Pass 2: one thread per (b, c, column) sums the chunks in chunk order.
// k is tiled by 64: a block only accumulates (and only loads x for) the rows
// whose idx falls in its tile.  The accumulator is then 8 KB, so up to 32
// one-warp blocks fit an SM; with a whole-k accumulator (32 KB at k=256)
// only 7 did, and the row stream was latency-bound.  x is still read once;
// idx and w are read once per k tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 32;      // columns per block: one warp, one lane per column
constexpr int PREFETCH = 16;  // rows loaded ahead into registers
constexpr int K_TILE = 64;    // clusters per block: an 8 KB accumulator

__global__ void __launch_bounds__(COLS)
segsum_partial_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const int32_t* __restrict__ idx, float* __restrict__ ws,
                      int n, int d, int k, int rows_per_chunk, int chunks,
                      int k_tile, int n_ktiles) {
  extern __shared__ float acc[];  // (k_tile, COLS); lane owns column `lane`
  const int chunk = blockIdx.x;
  const int dchunk = blockIdx.y / n_ktiles;
  const int kt = blockIdx.y % n_ktiles;
  const int b = blockIdx.z;
  const int lane = threadIdx.x;
  const int col = dchunk * COLS + lane;  // in [0, d]; column d is the totals
  const int c0 = kt * k_tile;
  const int kc = min(k_tile, k - c0);

  for (int c = 0; c < kc; ++c) acc[c * COLS + lane] = 0.f;

  const long long r0 = (long long)chunk * rows_per_chunk;
  const long long r1 = min((long long)n, r0 + rows_per_chunk);
  const float* xb = x + (long long)b * n * d;
  const float* wb = w + (long long)b * n;
  const int32_t* ib = idx + (long long)b * n;

  for (long long r = r0; r < r1; r += PREFETCH) {
    int ci[PREFETCH];
    float v[PREFETCH];
#pragma unroll
    for (int q = 0; q < PREFETCH; ++q) {
      const long long rr = r + q;
      ci[q] = -1;
      v[q] = 0.f;
      if (rr < r1) {
        const int ii = ib[rr];
        ci[q] = ((unsigned)ii < (unsigned)k) ? ii - c0 : -1;
        if ((unsigned)ci[q] < (unsigned)kc) v[q] = wb[rr] * (col < d ? xb[rr * d + col] : 1.f);
      }
    }
#pragma unroll
    for (int q = 0; q < PREFETCH; ++q)
      if ((unsigned)ci[q] < (unsigned)kc) acc[ci[q] * COLS + lane] += v[q];
  }

  if (col <= d) {
    const int D1 = d + 1;
    float* out = ws + (((long long)b * chunks + chunk) * k + c0) * D1 + col;
    for (int c = 0; c < kc; ++c) out[(long long)c * D1] = acc[c * COLS + lane];
  }
}

__global__ void segsum_reduce_kernel(const float* __restrict__ ws, float* __restrict__ sums,
                                     float* __restrict__ totals, int B, int chunks, int k,
                                     int d) {
  const int D1 = d + 1;
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= (long long)B * k * D1) return;
  const int col = (int)(e % D1);
  const long long bc = e / D1;  // b * k + c
  const int c = (int)(bc % k);
  const long long b = bc / k;
  const long long stride = (long long)k * D1;
  const float* p = ws + (b * chunks * k + c) * D1 + col;
  float s = 0.f;
  for (int ch = 0; ch < chunks; ++ch) s += p[ch * stride];
  if (col < d)
    sums[bc * d + col] = s;
  else
    totals[bc] = s;
}

}  // namespace

// x (B, n, d) fp32, w (B, n) fp32, idx (B, n) int32, all contiguous;
// ws (B, chunks, k, d+1) fp32 scratch with chunks = ceil(n / rows_per_chunk);
// sums (B, k, d) and totals (B, k) fp32 out.  Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() of the launches.
extern "C" int weighted_segsum_launch(const float* x, const float* w, const int32_t* idx,
                                      float* ws, float* sums, float* totals, int B, int n,
                                      int d, int k, int rows_per_chunk, int chunks,
                                      void* stream) {
  if (B <= 0 || n <= 0 || d <= 0 || k <= 0 || rows_per_chunk <= 0 || B > 65535 ||
      chunks != (n + rows_per_chunk - 1) / rows_per_chunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k_tile = k < K_TILE ? k : K_TILE;
  const int n_ktiles = (k + k_tile - 1) / k_tile;
  const int dchunks = (d + 1 + COLS - 1) / COLS;
  if ((long long)dchunks * n_ktiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)k_tile * COLS * sizeof(float);  // <= 8 KB
  dim3 grid1(chunks, dchunks * n_ktiles, B);
  segsum_partial_kernel<<<grid1, COLS, smem, s>>>(x, w, idx, ws, n, d, k, rows_per_chunk,
                                                  chunks, k_tile, n_ktiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * k * (d + 1);
  const int threads = 256;
  segsum_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
      ws, sums, totals, B, chunks, k, d);
  return (int)cudaGetLastError();
}
