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
//   Pass 1: grid (row ranges of rows_per_chunk rows, column slices x k
//     tiles, B).  A block owns one row range of one batch and keeps the
//     whole (k, d+1) accumulator in shared memory (129 KB at k = 256,
//     d = 128).  Where that exceeds the budget left beside the ring (about
//     160 KB), the block owns a slice of columns as wide as fits, and only
//     where not even 32 columns fit is k tiled as well.  One producer warp
//     streams the range's rows through a ring of 32-row stages with
//     mbarrier completion: x by one cp.async.bulk per stage where d % 4 == 0
//     and the block holds every column (d = 128), 4-byte cp.async of the
//     slice's columns otherwise (d = 2, 13: rows that are not 16-byte
//     aligned); idx and w by 4-byte cp.async, whose completion the lanes
//     signal with cp.async.mbarrier.arrive.noinc.  Each consumer warp owns
//     32 columns, a lane one column, and walks the staged rows in row order,
//     adding w*x into its columns of the accumulator (the lane of column d
//     adds w).  No two threads write the same (cluster, column).  The shared
//     read-modify-write of row r + 1 would wait on row r's, so the rows go
//     in groups of 8: the group's 8 accumulator entries are loaded together,
//     each row adds to the entry of the latest earlier row of the group with
//     the same cluster (or to the loaded one), in row order, and the 8
//     results are stored in row order; a group whose clusters are all
//     distinct (__match_any_sync) skips that search.  That is exactly the sequential sum,
//     acc = (acc + v_0) + v_1 ..., with every w*x rounded before it is added
//     (__fmul_rn, __fadd_rn: never contracted), so the same bits on every
//     run.  The block then writes its partial to the workspace
//     (B, chunks, k, d+1).
//   Pass 2: one thread per (b, c, column) sums the chunks in chunk order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RS = 32;        // rows per stage of the ring
constexpr int G = 8;          // rows whose accumulator updates are issued together
constexpr int MAXW = 8;       // consumer warps at most: slices of up to 256 columns
constexpr int SMEM_MAX = 232448;  // shared memory a block can use (227 KB)
constexpr int MAX_STAGES = 8;
constexpr int BARS = 128;     // bytes for the full and empty mbarriers of MAX_STAGES stages

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits for the phase of parity `parity` to complete.  A watchdog traps
// after about ten seconds, so a lost arrival faults the launch (an error
// the caller sees) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One 4-byte asynchronous copy from device memory into shared memory.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// Arrives on `bar` once this thread's earlier cp.async copies have landed
// (.noinc: the barrier's count includes this arrival).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) into shared memory;
// the barrier counts them.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Shared memory: [full, empty mbarriers][idx ring][w ring][x ring][accumulator].
//   sw: columns of a slice (a multiple of 32: one consumer warp per 32),
//   as: the accumulator's row stride (the widest slice's columns),
//   kt_size: clusters per k tile, xw: floats of a staged x row.
template <bool BULK>
__global__ void __launch_bounds__(32 * (MAXW + 1))
segsum_partial_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const int32_t* __restrict__ idx, float* __restrict__ ws,
                      int n, int d, int k, int rows_per_chunk, int chunks,
                      int sw, int as, int kt_size, int n_ktiles, int xw, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  int32_t* i_ring = reinterpret_cast<int32_t*>(smem + BARS);
  float* w_ring = reinterpret_cast<float*>(i_ring + stages * RS);
  float* x_ring = w_ring + stages * RS;
  float* acc = x_ring + stages * RS * xw;

  const int chunk = blockIdx.x;
  const int slice = blockIdx.y / n_ktiles;
  const int kt = blockIdx.y % n_ktiles;
  const int b = blockIdx.z;
  const int D1 = d + 1;
  const int s0 = slice * sw;                // first column of the slice
  const int width = min(sw, D1 - s0);       // its columns, the totals column d included
  const int xcols = max(0, min(width, d - s0));  // its columns of x
  const int c0 = kt * kt_size;
  const int kc = min(kt_size, k - c0);
  const int nw = blockDim.x / 32 - 1;      // consumer warps; warp nw is the producer
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long r0 = (long long)chunk * rows_per_chunk;
  const int rows = (int)min((long long)rows_per_chunk, (long long)n - r0);
  const int nst = (rows + RS - 1) / RS;

  // Zero the accumulator (kc + 1 rows of `as` floats; it starts 16-byte
  // aligned: every stage of the ring is a multiple of 128 bytes).
  {
    const int total = (kc + 1) * as;
    float4* acc4 = reinterpret_cast<float4*>(acc);
    for (int e = threadIdx.x; e < total / 4; e += blockDim.x) acc4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e = total / 4 * 4 + threadIdx.x; e < total; e += blockDim.x) acc[e] = 0.f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 32 + 1);  // the producer lanes' cp.async arrivals + lane 0's
      mbar_init(&empty[s], nw);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == nw) {
    // Producer: stage s of the range into slot s % stages once the
    // consumers have released that slot's previous stage.
    const float* xb = x + ((long long)b * n + r0) * d;
    const float* wb = w + (long long)b * n + r0;
    const int32_t* ib = idx + (long long)b * n + r0;
    for (int s = 0; s < nst; ++s) {
      const int slot = s % stages;
      if (s >= stages) mbar_wait(&empty[slot], ((s / stages) - 1) & 1);
      const int rr = s * RS;
      const int m = min(RS, rows - rr);
      float* xdst = x_ring + slot * RS * xw;
      if (lane < m) {
        cp_async4(i_ring + slot * RS + lane, ib + rr + lane);
        cp_async4(w_ring + slot * RS + lane, wb + rr + lane);
      } else {
        i_ring[slot * RS + lane] = -1;  // a row past the range: in no cluster
      }
      if (!BULK) {
        for (int e = lane; e < m * xcols; e += 32) {
          const int q = e / xcols, col = e - q * xcols;
          cp_async4(xdst + q * xw + col, xb + (long long)(rr + q) * d + s0 + col);
        }
      }
      cp_async_arrive(&full[slot]);
      __syncwarp();  // the -1 entries above are published by lane 0's arrival
      if (lane == 0) {
        if (BULK) {
          mbar_expect_tx(&full[slot], (uint32_t)(m * d * 4));
          bulk_copy(xdst, xb + (long long)rr * d, (uint32_t)(m * d * 4), &full[slot]);
        } else {
          mbar_arrive(&full[slot]);
        }
      }
    }
  } else {
    // Consumers: lane `lane` of warp `warp` owns column s0 + lc of the slice.
    const int lc = warp * 32 + lane;
    const bool active = lc < width;
    const bool is_x = s0 + lc < d;  // false: the totals column, whose "x" is 1
    const int xl = is_x ? lc : 0;   // the staged x column this lane reads
    const int al = active ? lc : 0;  // the accumulator column this lane reads
    for (int s = 0; s < nst; ++s) {
      const int slot = s % stages;
      mbar_wait(&full[slot], (s / stages) & 1);
      const int m = min(RS, rows - s * RS);
      const int32_t* ci = i_ring + slot * RS;
      const float* wi = w_ring + slot * RS;
      const float* xr = x_ring + slot * RS * xw;
      for (int g0 = 0; g0 < m; g0 += G) {
        // The group's idx and w: 16-byte broadcast reads (the ring's stages
        // and groups start 16-byte aligned).
        int ids[G];
        float wts[G];
#pragma unroll
        for (int q = 0; q < G; q += 4) {
          const int4 i4 = *reinterpret_cast<const int4*>(ci + g0 + q);
          const float4 w4 = *reinterpret_cast<const float4*>(wi + g0 + q);
          ids[q] = i4.x, ids[q + 1] = i4.y, ids[q + 2] = i4.z, ids[q + 3] = i4.w;
          wts[q] = w4.x, wts[q + 1] = w4.y, wts[q + 2] = w4.z, wts[q + 3] = w4.w;
        }
        // No branches: a row outside the tile (or past the range: idx -1)
        // adds into the spare row kc of the accumulator, which is never
        // written out, and an idle lane reads column 0; so the shared loads
        // issue together and only an idle lane's stores are skipped.
        int cq[G];
        float v[G], a[G];
#pragma unroll
        for (int q = 0; q < G; ++q) {
          const int c = ids[q] - c0;
          cq[q] = (unsigned)c < (unsigned)kc ? c : kc;
          const float xv = xr[(g0 + q) * xw + xl];
          v[q] = __fmul_rn(wts[q], is_x ? xv : 1.f);
        }
#pragma unroll
        for (int q = 0; q < G; ++q) a[q] = acc[cq[q] * as + al];
        // Does a cluster occur twice in the group?  Lane l holds the cluster
        // of row l % G, so a row alone matches 32 / G lanes, a repeated one more.
        const int mine = ci[g0 + (lane & (G - 1))] - c0;
        const unsigned same = __match_any_sync(0xffffffffu, (unsigned)mine < (unsigned)kc ? mine : kc);
        const bool repeats = __any_sync(0xffffffffu, __popc(same) > 32 / G);
        if (repeats) {
          // In row order: each row adds to its cluster's latest value in the group.
#pragma unroll
          for (int q = 0; q < G; ++q) {
            float base = a[q];
#pragma unroll
            for (int p = 0; p < q; ++p)
              if (cq[p] == cq[q]) base = a[p];
            a[q] = __fadd_rn(base, v[q]);
          }
        } else {
#pragma unroll
          for (int q = 0; q < G; ++q) a[q] = __fadd_rn(a[q], v[q]);
        }
        if (active) {
#pragma unroll
          for (int q = 0; q < G; ++q) acc[cq[q] * as + lc] = a[q];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
  }
  __syncthreads();

  // The partial: warp j writes clusters j, j + warps, ..., a lane a column.
  float* out = ws + (((long long)b * chunks + chunk) * k + c0) * D1 + s0;
  const int warps = blockDim.x / 32;
  for (int c = warp; c < kc; c += warps)
    for (int col = lane; col < width; col += 32) out[(long long)c * D1 + col] = acc[c * as + col];
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
  const int D1 = d + 1;
  // The ring: 32-row stages of idx, w and the widest slice's x columns, at
  // least two; the accumulator gets what two stages leave, and the ring
  // then takes what the accumulator leaves, up to MAX_STAGES.
  const int sw0 = min((D1 + 31) / 32 * 32, 32 * MAXW);
  const int xw = min(sw0, d);
  const long long stage = (long long)RS * (xw * 4 + 8);
  const long long budget = SMEM_MAX - BARS - 2 * stage - 16;
  // Whole k and every column where they fit; else slices of columns as wide
  // as fit; else 32-column slices and k tiles.
  int sw = sw0, kt_size = k;
  // (An accumulator holds kt_size + 1 rows: the last takes what no cluster of the tile takes.)
  if ((long long)(k + 1) * min(sw0, D1) * 4 > budget) {
    sw = (int)(budget / (4LL * (k + 1))) / 32 * 32;
    if (sw > sw0) sw = sw0;
    if (sw < 32) {
      sw = 32;
      kt_size = (int)(budget / (32 * 4)) - 1;
    }
  }
  const int as = min(sw, D1);
  const int slices = (D1 + sw - 1) / sw;
  const int n_ktiles = (k + kt_size - 1) / kt_size;
  if ((long long)slices * n_ktiles > 65535 || budget <= 0) return (int)cudaErrorInvalidValue;
  const long long acc_bytes = (long long)(kt_size + 1) * as * 4;
  const long long fit = (SMEM_MAX - BARS - 16 - acc_bytes) / stage;
  const int stages = fit < MAX_STAGES ? (int)fit : MAX_STAGES;
  const size_t smem = BARS + ((size_t)stages * stage + 15) / 16 * 16 + acc_bytes;
  const int threads = 32 * (sw / 32 + 1);
  const bool bulk = slices == 1 && d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto kern = bulk ? segsum_partial_kernel<true> : segsum_partial_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid1(chunks, slices * n_ktiles, B);
  kern<<<grid1, threads, smem, s>>>(x, w, idx, ws, n, d, k, rows_per_chunk, chunks, sw, as, kt_size,
                                    n_ktiles, xw, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * k * (d + 1);
  const int rthreads = 256;
  segsum_reduce_kernel<<<(unsigned)((total + rthreads - 1) / rthreads), rthreads, 0, s>>>(
      ws, sums, totals, B, chunks, k, d);
  return (int)cudaGetLastError();
}
