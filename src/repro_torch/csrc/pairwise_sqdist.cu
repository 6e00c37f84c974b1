// Full squared-distance matrix for Hopper (sm_90a): fp32-accurate dot
// products on the TF32 tensor cores (3xTF32 by wgmma), clamped tiles stored
// by TMA.
//
// Replaces: src/repro/kernels/pairwise_dist/kernel.py `_sqdist_kernel` via
// `pairwise_sqdist_kernel_call` (the Pallas TPU kernel).
//
// Computes, for x (n, d) and c (k, d):
//     out[i, j] = max(|x_i|^2 + |c_j|^2 - 2 x_i.c_j, 0)        (n, k) fp32
// in the decomposition of the Pallas kernel's `_sqdist_block`, every element
// written once.
//
// Bound: the bytes.  x is read once and the (n, k) output written once: at
// (1M x 128) x (256 x 128), 0.51 + 1.02 GB, 0.459 ms at 3.35 TB/s.  The three
// TF32 passes of x.c^T (3xTF32, as assign_min.cu) take 0.397 ms at 495
// TFLOP/s, so a kernel whose products overlap its stores is bound by the
// stores; one fp32 CUDA-core pass would need 0.978 ms.
//
// Design: the tile of assign_min.cu (helpers in tf32_tile.cuh): 128 rows x
// TN centers, TN = 256 where k > 128 and 128 otherwise; d in chunks of 32
// columns, each value split once into big + small TF32 pieces in swizzled
// K-major panels, three wgmma m64nTNk8 .tf32 per 8 columns (small.big +
// big.small + big.big, in that order), chunk s + 1 staged into the other
// buffer while the products of chunk s run; norms are fp32 FMA sums of the
// raw staged values.  Blocks are persistent: one per SM walks the (row
// tile, center tile) pairs, and a tile's first chunk is loaded into
// registers while the tile before it multiplies.  At the end of a (row tile, center tile)
// the block clamps its accumulators into an output tile in shared memory,
// reusing the stage buffers (TN/32 panels of 128 rows x 128 bytes: 128 KB of
// the 192 KB at TN = 256), in the same 128-byte swizzle as the input panels,
// so a warp's stores hit distinct banks.  Where the row pitch k*4 is a
// multiple of 16 bytes, one thread stores the tile by TN/32 TMA tensor
// stores (cp.async.bulk.tensor.2d, clipped at n and k by the hardware) and
// the block goes on to the next tile's loads and products while they drain
// to device memory: it waits only until the stores have read the shared tile
// (cp.async.bulk.wait_group.read) before it stages into the buffers again.
// Elsewhere (k % 4 != 0) the block copies the tile out with coalesced
// 4-byte stores.  No atomics: every output element has one writer.
//
// Edges: rows >= n and columns >= k are staged as 0 and never stored; a
// ragged d is staged as 0 past its end (16-byte loads where d % 4 == 0 and
// the bases are 16-byte aligned, 4-byte loads otherwise).  The wrapper
// raises on d = 0 and skips the launch for n = 0 or k = 0.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_tile.cuh"

namespace {

using namespace tf32_tile;

constexpr int TM = 128;       // rows of x per tile (two warpgroups of 64)
constexpr int DK = 32;        // columns of d per chunk: one 128-byte swizzle atom of fp32
constexpr int THREADS = 256;
constexpr int ROW = DK * 4;   // bytes of a staged row, and of a row of an output panel

// Two stage buffers, each of x big, x small (TM rows) and c big, c small (TN
// rows), + alignment slack.
template <int TN>
constexpr int smem_bytes() { return 2 * 2 * (TM + TN) * ROW + 1024; }

// One 32-column x 128-row box of the output from a swizzled shared panel.
__device__ __forceinline__ void tma_store(const CUtensorMap& map, const void* src, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_u32(src)), "r"(col), "r"(row)
      : "memory");
}

template <int TN, bool VEC, bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
pairwise_sqdist_kernel(const __grid_constant__ CUtensorMap out_map, const float* __restrict__ x,
                       const float* __restrict__ c, float* __restrict__ out, int n, int k, int d) {
  constexpr int XP = TM * ROW;     // bytes of an x panel, and of an output panel
  constexpr int CP = TN * ROW;     // bytes of a c panel
  constexpr int BUF = 2 * XP + 2 * CP;
  constexpr int CR = TN / 32;      // c rows staged per thread
  constexpr int NA = TN / 2;       // accumulators per thread
  static_assert((TN / 32) * XP <= 2 * BUF, "the output tile fits in the stage buffers");
  extern __shared__ unsigned char smem_raw[];
  // [buffer][x big, x small, c big, c small][rows][128 bytes], 1024-byte aligned;
  // after a tile's products, [TN / 32 output panels][TM rows][128 bytes]
  unsigned char* panels = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ float xn_s[TM];  // |x_r|^2 of the current tile's rows
  __shared__ float cn_s[TN];  // |c_j|^2 of the current center tile

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int g = lane >> 2;  // accumulator row within the warp's 16
  const int t = lane & 3;   // accumulator column pair
  const int my_row = wg * 64 + ((tid % 128) / 32) * 16 + g;  // this thread's rows: my_row, my_row + 8
  // Staging: thread tid moves 16-byte chunk tid % 8 of rows tid / 8 + 32 i.
  const int lr = tid >> 3;
  const int c4 = tid & 7;

  const int n_ch = (d + DK - 1) / DK;
  const int row_tiles = (n + TM - 1) / TM;
  const int col_tiles = (k + TN - 1) / TN;
  bool pending = false;  // thread 0: TMA stores that may still read the output panels

  float acc[NA];
  float4 xv[4], cv[CR];
  // Chunk ch of the tile at (r0, c0) into registers.
  auto load_chunk = [&](int ch, int r0, int c0) {
    const int k0 = ch * DK + c4 * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = load4<VEC>(x, r0 + lr + 32 * i, n, k0, d);
#pragma unroll
    for (int i = 0; i < CR; ++i) cv[i] = load4<VEC>(c, c0 + lr + 32 * i, k, k0, d);
  };
  // Tile t is row tile t / col_tiles, center tile t % col_tiles.  Its first
  // chunk is loaded while the tile before it multiplies.
  const int tiles = row_tiles * col_tiles;
  load_chunk(0, (blockIdx.x / col_tiles) * TM, (blockIdx.x % col_tiles) * TN);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = (tile / col_tiles) * TM;
    const int col0 = (tile % col_tiles) * TN;
    float xpart[4] = {0.f, 0.f, 0.f, 0.f};  // |x|^2 parts of rows lr + 32 i
    float cpart[CR];  // |c|^2 parts of centers lr + 32 i
#pragma unroll
    for (int i = 0; i < CR; ++i) cpart[i] = 0.f;

    auto load = [&](int ch) { load_chunk(ch, row0, col0); };
    // Norm parts, split, and the panels of buffer ch % 2.
    auto stage = [&](int ch) {
      unsigned char* buf = panels + (ch & 1) * BUF;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xpart[i] = sumsq(xpart[i], xv[i]);
        store_split(buf, buf + XP, lr + 32 * i, c4, xv[i]);
      }
#pragma unroll
      for (int i = 0; i < CR; ++i) {
        cpart[i] = sumsq(cpart[i], cv[i]);
        store_split(buf + 2 * XP, buf + 2 * XP + CP, lr + 32 * i, c4, cv[i]);
      }
      // The panels are read by wgmma (the async proxy): make the stores visible to it.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    };

    // The previous tile's stores read the output panels, which overlap the
    // buffers: staging waits until they have been read (not written).
    if (TMA && pending) {
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      pending = false;
    }
    __syncthreads();
    stage(0);
    if (n_ch > 1) load(1);
    __syncthreads();
    for (int ch = 0; ch < n_ch; ++ch) {
      const int ksteps = min(DK, d - ch * DK + 7) / 8;  // 8-column steps holding columns < d
      const unsigned char* buf = panels + (ch & 1) * BUF;
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
      if (ch + 1 < n_ch) {
        // Chunk ch - 1's products, the last readers of the other buffer, are done.
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        __syncthreads();
        stage(ch + 1);
        if (ch + 2 < n_ch) load(ch + 2);
      }
      if (ch == max(n_ch - 2, 0)) {
        // The last chunk is staged and the registers are free: the next
        // tile's first chunk, whose latency the rest of this tile hides.
        const int next = tile + gridDim.x;
        if (next < tiles) load_chunk(0, (next / col_tiles) * TM, (next % col_tiles) * TN);
      }
      __syncthreads();
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < CR; ++i) {
      const float cn = row_sum(cpart[i]);
      if (c4 == 0) cn_s[lr + 32 * i] = cn;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xnv = row_sum(xpart[i]);
      if (c4 == 0) xn_s[lr + 32 * i] = xnv;
    }
    // Every warpgroup's products are complete: the buffers are free.
    __syncthreads();
    const float xn[2] = {xn_s[my_row], xn_s[my_row + 8]};
    // The clamped tile into the output panels: column cl of row r at panel
    // cl / 32, 16-byte chunk (cl % 32) / 4 swizzled by r % 8.
#pragma unroll
    for (int nt = 0; nt < TN / 8; ++nt) {
      const int cl = nt * 8 + 2 * t;
      const float cn0 = cn_s[cl], cn1 = cn_s[cl + 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = my_row + 8 * r;
        float2 v;
        v.x = fmaxf(xn[r] + cn0 - 2.f * acc[nt * 4 + 2 * r], 0.f);
        v.y = fmaxf(xn[r] + cn1 - 2.f * acc[nt * 4 + 2 * r + 1], 0.f);
        const int within = cl & 31;
        unsigned char* p = panels + (cl >> 5) * XP + row * ROW + (((within >> 2) ^ (row & 7)) << 4) +
                           (within & 3) * 4;
        *reinterpret_cast<float2*>(p) = v;
      }
    }
    if (TMA) {
      // Generic stores, read by the TMA unit (the async proxy).
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (tid == 0) {
        for (int p = 0; p < TN / 32 && col0 + 32 * p < k; ++p)
          tma_store(out_map, panels + p * XP, col0 + 32 * p, row0);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        pending = true;
      }
    } else {
      __syncthreads();
      for (int e = tid; e < TM * TN; e += THREADS) {
        const int r = e / TN, cl = e % TN;
        const int row = row0 + r, col = col0 + cl;
        if (row < n && col < k) {
          const int within = cl & 31;
          out[(long long)row * k + col] = *reinterpret_cast<const float*>(
              panels + (cl >> 5) * XP + r * ROW + (((within >> 2) ^ (r & 7)) << 4) + (within & 3) * 4);
        }
      }
    }
  }
  // The shared tile must outlive the stores that read it.
  if (TMA && pending) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, found through the runtime: no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

template <int TN, bool VEC, bool TMA>
int launch(const CUtensorMap& map, const float* x, const float* c, float* out, int n, int k, int d,
           cudaStream_t stream) {
  auto kern = pairwise_sqdist_kernel<TN, VEC, TMA>;
  constexpr int smem = smem_bytes<TN>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((n + TM - 1) / TM) * ((k + TN - 1) / TN);
  const int grid = tiles < sms ? (int)tiles : sms;  // persistent: one block per SM
  kern<<<grid, THREADS, smem, stream>>>(map, x, c, out, n, k, d);
  return (int)cudaGetLastError();
}

template <int TN, bool VEC>
int launch_store(const float* x, const float* c, float* out, int n, int k, int d, cudaStream_t stream) {
  CUtensorMap map = {};
  // TMA needs a row pitch of a multiple of 16 bytes and a 16-byte aligned start.
  if (k % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return (int)cudaErrorNotSupported;
    // dimension 0: the k columns (box 32, one 128-byte swizzle atom); 1: the n rows (box TM)
    const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)n};
    const cuuint64_t strides[1] = {(cuuint64_t)k * 4};
    const cuuint32_t box[2] = {32, TM};
    const cuuint32_t unit[2] = {1, 1};
    if (enc(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, out, dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
    return launch<TN, VEC, true>(map, x, c, out, n, k, d, stream);
  }
  return launch<TN, VEC, false>(map, x, c, out, n, k, d, stream);
}

}  // namespace

// x (n, d), c (k, d) fp32 contiguous; out (n, k) fp32.  Launches on
// `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError() of the launch.
extern "C" int pairwise_sqdist_launch(const float* x, const float* c, float* out,
                                      int n, int k, int d, void* stream) {
  if (n <= 0 || k <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  // Tiles of 256 centers where k needs more than 128 (k = 256 is one tile,
  // so x is read once), 128 otherwise.
  if (k > 128)
    return vec ? launch_store<256, true>(x, c, out, n, k, d, st) : launch_store<256, false>(x, c, out, n, k, d, st);
  return vec ? launch_store<128, true>(x, c, out, n, k, d, st) : launch_store<128, false>(x, c, out, n, k, d, st);
}
