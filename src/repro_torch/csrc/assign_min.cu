// Fused nearest-center assignment for Hopper (sm_90a), fp32-accurate dot
// products on the TF32 tensor cores (3xTF32 by wgmma).
//
// Replaces: src/repro/kernels/pairwise_dist/kernel.py `_assign_kernel` via
// `assign_min_kernel_call` (the Pallas TPU kernel).
//
// Computes, for each batch b and row i of x (B, n, d) against the centers
// c (B, k, d):
//     d2[j] = max(|x_i|^2 + |c_j|^2 - 2 x_i.c_j, 0)   for j < k_valid
//     idx[b, i] = first j with the least d2,  dist[b, i] = |x_i - c_idx|^2
// (the chosen center's distance summed directly in fp32, see the epilogue).
// The (n, k) matrix never reaches device memory.  Columns >= k_valid are
// skipped by index (never by padding coordinates: huge pad coordinates
// overflow |c|^2 and give inf - inf = NaN).  With no valid column the
// result is idx 0 and dist PAD_DIST, as in the Pallas kernel.
//
// Bound: the 2*B*n*k*d operations of x.c^T.  One TF32 pass keeps 11
// significant bits of each operand, too few for the index parity with the
// fp32 reference, so each operand is split once, as it is staged:
// big = cvt.rna.tf32(v), small = cvt.rna.tf32(v - big), and the product is
// small.big + big.small + big.big summed in fp32 on the tensor cores, in that
// order; the dropped small.small term and the residuals are about 2^-22 of
// |x||c| per product, but the tensor cores' fp32 accumulation truncates, so
// the 3 d/8 accumulations of a row add up to a bias of a few 2^-22 |x||c|
// (d2 of the nearest center high by 1e-4 at |x|^2 = 43, d = 128, measured
// on the H100): the index is chosen from these d2, and the returned dist is
// recomputed directly for the chosen center.  That is three TF32 passes: at the local-solve shape of Algorithm
// 1, (10, 211349, 256, 128), 0.84 ms on the 495 TFLOP/s of the TF32 tensor
// cores, above the 0.33 ms of bytes.  The fp32 CUDA-core rate (67 TFLOP/s)
// would need 2.07 ms for one pass.
//
// Design: one block of two warpgroups per 128 rows of x, looping over tiles
// of TN centers and, within a tile, over chunks of 32 columns of d.  TN is
// 256 where k_valid > 128 (Algorithm 1's k = 256 is one tile, so x is read
// once; wgmma m64n256k8, 128 accumulators a thread) and 128 otherwise (the
// small k of the paper's size and of the coresets).  Each thread loads its
// share of a chunk of x and c into registers (16-byte loads where d % 4 == 0
// and both bases are 16-byte aligned, 4-byte loads otherwise: d = 2 at the
// paper's size, d = 13 in the tests; zeros past d, n and k_valid), adds their
// squares to its norm sums, splits them and stores big and small into shared
// memory in the 128-byte-swizzled K-major layout of wgmma (a row of 32 floats
// is one swizzle atom).  Each warpgroup runs wgmma m64nTNk8 .tf32 from shared
// memory for its 64 rows, three products per 8 columns of d.  The products
// of chunk s + 1 queue behind those of chunk s, and the block stages chunk
// s + 1 into the other buffer while they run, so the tensor cores drain only
// at the end of a tile; every value is split once, not once per warp that
// reads it.  Shared memory: two buffers of x big, x small (16 KB each) and
// c big, c small (TN x 128 bytes each): 192 KB at TN = 256, 128 KB at 128.
// The norms |x_i|^2 and |c_j|^2 are fp32 FMA sums of the raw values in a
// fixed order (4 columns a thread per chunk, then across the 8 threads of a
// row), so one launch does the call.
//
// Tie rule: every column goes through the same instructions (so exact
// duplicate centers, which k-median++ evaluates on every step, get bitwise
// equal d2); d2 is clamped at 0 BEFORE comparing; every thread walks its
// columns in increasing order with a strict '<'; the 4 lanes that share a
// row merge (dist, idx) lexicographically.  So ties resolve to the earliest
// index, exactly as jnp.argmin / torch.argmin.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_tile.cuh"

namespace {

constexpr int TM = 128;       // rows of x per block (two warpgroups of 64)
constexpr int DK = 32;        // columns of d per chunk: one 128-byte swizzle atom of fp32
constexpr int THREADS = 256;
constexpr int ROW = DK * 4;   // bytes of a staged row

// Shared memory of a block with tiles of TN centers: two buffers, each of x
// big, x small (TM rows) and c big, c small (TN rows), + alignment slack.
template <int TN>
constexpr int smem_bytes() { return 2 * 2 * (TM + TN) * ROW + 1024; }
constexpr float PAD_DIST = 3.4e38f;

using namespace tf32_tile;

template <int TN, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
assign_min_kernel(const float* __restrict__ x, const float* __restrict__ c,
                  int32_t* __restrict__ idx_out, float* __restrict__ dist_out,
                  int n, int k, int d, int kv) {
  constexpr int XP = TM * ROW;     // bytes of an x panel
  constexpr int CP = TN * ROW;     // bytes of a c panel
  constexpr int BUF = 2 * XP + 2 * CP;
  constexpr int CR = TN / 32;      // c rows staged per thread
  constexpr int NA = TN / 2;       // accumulators per thread
  extern __shared__ unsigned char smem_raw[];
  // [buffer][x big, x small, c big, c small][rows][128 bytes], 1024-byte aligned
  unsigned char* panels = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ float xn_s[TM];  // |x_r|^2 of the block's rows
  __shared__ float cn_s[TN];  // |c_j|^2 of the current center tile

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int g = lane >> 2;  // accumulator row within the warp's 16
  const int t = lane & 3;   // accumulator column pair
  const int my_row = wg * 64 + ((tid % 128) / 32) * 16 + g;  // this thread's rows: my_row, my_row + 8
  const float* xb = x + (long long)b * n * d;
  const float* cb = c + (long long)b * k * d;

  // Staging: thread tid moves 16-byte chunk tid % 8 of rows tid / 8 + 32 i.
  const int lr = tid >> 3;
  const int c4 = tid & 7;

  const int n_ch = (d + DK - 1) / DK;
  const int steps = ((kv + TN - 1) / TN) * n_ch;  // (center tile, chunk of d) pairs

  float xpart[4] = {0.f, 0.f, 0.f, 0.f};  // |x|^2 parts of rows lr + 32 i
  float cpart[2][CR] = {};                // |c|^2 parts of centers lr + 32 i, by tile parity
  float best[2] = {PAD_DIST, PAD_DIST};
  int besti[2] = {0, 0};
  float xn[2] = {0.f, 0.f};
  float acc[NA];
  float4 xv[4], cv[CR];

  auto load = [&](int s) {
    const int k0 = (s % n_ch) * DK + c4 * 4;
    const int c0 = (s / n_ch) * TN;
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = load4<VEC>(xb, row0 + lr + 32 * i, n, k0, d);
#pragma unroll
    for (int i = 0; i < CR; ++i) cv[i] = load4<VEC>(cb, c0 + lr + 32 * i, kv, k0, d);
  };
  // Norm parts, split, and the panels of buffer s % 2.
  auto stage = [&](int s) {
    unsigned char* buf = panels + (s & 1) * BUF;
    const bool odd = (s / n_ch) & 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (s < n_ch) xpart[i] = sumsq(xpart[i], xv[i]);
      store_split(buf, buf + XP, lr + 32 * i, c4, xv[i]);
    }
#pragma unroll
    for (int i = 0; i < CR; ++i) {
      if (odd) cpart[1][i] = sumsq(cpart[1][i], cv[i]);
      else cpart[0][i] = sumsq(cpart[0][i], cv[i]);
      store_split(buf + 2 * XP, buf + 2 * XP + CP, lr + 32 * i, c4, cv[i]);
    }
    // The panels are read by wgmma (the async proxy): make the stores visible to it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  if (steps > 0) {
    load(0);
    stage(0);
    if (steps > 1) load(1);
  }
  __syncthreads();
  // Step s: the products of chunk s are issued, then (while they and the
  // products still queued before them run) the block stages chunk s + 1
  // into the other buffer once every warpgroup's products of chunk s - 1,
  // its last readers, are done.  The tensor cores drain only at tile ends.
  for (int s = 0; s < steps; ++s) {
    const int ct = s / n_ch;
    const int ch = s % n_ch;
    const int ksteps = min(DK, d - ch * DK + 7) / 8;  // 8-column steps holding columns < d
    const unsigned char* buf = panels + (s & 1) * BUF;
    const unsigned char* xbig = buf + wg * 64 * ROW;
    const unsigned char* xsmall = xbig + XP;
    const unsigned char* cbig = buf + 2 * XP;
    const unsigned char* csmall = cbig + CP;

    fence_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int ks = 0; ks < ksteps; ++ks) {
      wgmma_tf32(acc, sw128_desc(xsmall + ks * 32), sw128_desc(cbig + ks * 32), ch > 0 || ks > 0);
      wgmma_tf32(acc, sw128_desc(xbig + ks * 32), sw128_desc(csmall + ks * 32), 1);
      wgmma_tf32(acc, sw128_desc(xbig + ks * 32), sw128_desc(cbig + ks * 32), 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_regs(acc);
    if (s + 1 < steps) {
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      __syncthreads();
      stage(s + 1);
      if (s + 2 < steps) load(s + 2);
    }

    if (ch == n_ch - 1) {
      // The tile's products are complete: its norms, then fold it into the
      // running minima, columns in increasing order.
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(acc);
      const int par = ct & 1;
#pragma unroll
      for (int i = 0; i < CR; ++i) {
        const float cn = row_sum(par ? cpart[1][i] : cpart[0][i]);
        if (c4 == 0) cn_s[lr + 32 * i] = cn;
        if (par) cpart[1][i] = 0.f;
        else cpart[0][i] = 0.f;
      }
      if (ct == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xnv = row_sum(xpart[i]);
          if (c4 == 0) xn_s[lr + 32 * i] = xnv;
        }
      }
      __syncthreads();
      if (ct == 0) {
        xn[0] = xn_s[my_row];
        xn[1] = xn_s[my_row + 8];
      }
#pragma unroll
      for (int nt = 0; nt < TN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = nt * 8 + 2 * t + e;
          if (ct * TN + cl < kv) {
            const float cn = cn_s[cl];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float d2 = fmaxf(xn[r] + cn - 2.f * acc[nt * 4 + 2 * r + e], 0.f);
              if (d2 < best[r]) {
                best[r] = d2;
                besti[r] = ct * TN + cl;
              }
            }
          }
        }
    }
    __syncthreads();  // chunk s + 1 is staged for all; cn_s is free again
  }

  // The 4 lanes of a quad hold the same two rows: merge (dist, idx) lexicographically.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float bd = best[r];
    int bi = besti[r];
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (od < bd || (od == bd && oi < bi)) {
        bd = od;
        bi = oi;
      }
    }
    const int row = row0 + my_row + 8 * r;
    // The chosen center's distance again, directly: |x_i - c_idx|^2 in fp32
    // FMAs, lane t of the quad taking columns 4t + 16m, then a fixed-order
    // sum across the quad (x and c are in L2: this block just read them).
    // The tensor cores' fp32 accumulation truncates, so x.c from the d/8 x 3
    // products of a row comes out low by a few ulps of |x||c| every time:
    // harmless for the choice of idx, but a bias of the minimum that a sum
    // of minima (a clustering cost) keeps whole.
    float part = 0.f;
    for (int col = 4 * t; col < d; col += 16) {
      const float4 xv4 = load4<VEC>(xb, row, n, col, d);
      const float4 cv4 = load4<VEC>(cb, bi, kv, col, d);
      const float dx = xv4.x - cv4.x, dy = xv4.y - cv4.y, dz = xv4.z - cv4.z, dw = xv4.w - cv4.w;
      part = fmaf(dw, dw, fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, part))));
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    if (bd < PAD_DIST) bd = part;  // no valid column (k_valid = 0) keeps PAD_DIST
    if (t == 0 && row < n) {
      idx_out[(long long)b * n + row] = bi;
      dist_out[(long long)b * n + row] = bd;
    }
  }
}

template <int TN, bool VEC>
int launch(const float* x, const float* c, int32_t* idx, float* dist, int B, int n, int k, int d, int kv,
           cudaStream_t stream) {
  auto kern = assign_min_kernel<TN, VEC>;
  constexpr int smem = smem_bytes<TN>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + TM - 1) / TM, B);
  kern<<<grid, THREADS, smem, stream>>>(x, c, idx, dist, n, k, d, kv);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, n, d), c (B, k, d) fp32 contiguous; idx (B, n) int32 and dist (B, n)
// fp32 out.  Launches on `stream`, does not synchronise, allocates nothing;
// returns cudaGetLastError() of the launch.
extern "C" int assign_min_launch(const float* x, const float* c, int32_t* idx, float* dist,
                                 int B, int n, int k, int d, int k_valid, void* stream) {
  if (B <= 0 || n <= 0 || d <= 0 || k < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const int kv = k_valid < k ? (k_valid < 0 ? 0 : k_valid) : k;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  // One tile of 256 centers where k_valid needs more than 128 (Algorithm 1
  // runs k = 256), tiles of 128 otherwise.
  if (kv > 128)
    return vec ? launch<256, true>(x, c, idx, dist, B, n, k, d, kv, st)
               : launch<256, false>(x, c, idx, dist, B, n, k, d, kv, st);
  return vec ? launch<128, true>(x, c, idx, dist, B, n, k, d, kv, st)
             : launch<128, false>(x, c, idx, dist, B, n, k, d, kv, st);
}
