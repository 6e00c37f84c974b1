// Fused nearest-center assignment for Hopper (sm_90a), fp32-accurate dot
// products on the TF32 tensor cores (3xTF32 by wgmma).
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
// Bound: the 2*B*n*k*d operations of x.c^T.  One TF32 pass keeps 11
// significant bits of each operand, too few for the index parity with the
// fp32 reference, so each operand is split once, as it is staged:
// big = cvt.rna.tf32(v), small = cvt.rna.tf32(v - big), and the product is
// small.big + big.small + big.big summed in fp32 on the tensor cores, in that
// order; the dropped small.small term and the residuals are about 2^-22 of
// |x||c|.  That is three TF32 passes: at the local-solve shape of Algorithm
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// v = big + small + (about 2^-22 v), big and small TF32 values rounded to
// nearest, ties away from zero.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(v - __uint_as_float(big)));
}

// Shared-memory matrix descriptor of a 128-byte-swizzled K-major panel whose
// rows are 128 bytes: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         1ull << 62;
}

// d (64 x 128, f32) = a (64 x 8) . b (128 x 8)^T + (scale_d ? d : 0), TF32 operands in
// shared memory, K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 256, f32) = a (64 x 8) . b (256 x 8)^T + (scale_d ? d : 0), TF32 operands in
// shared memory, K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_tf32(float (&d)[128], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products' issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Four consecutive columns [col, col + 4) of row `row` of a row-major
// (rows, d) matrix; zeros past `limit` rows and past d.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* src, int row, int limit, int col, int d) {
  if (row >= limit) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = src + (long long)row * d + col;
  if (VEC) return col < d ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(col < d ? __ldg(p) : 0.f, col + 1 < d ? __ldg(p + 1) : 0.f,
                     col + 2 < d ? __ldg(p + 2) : 0.f, col + 3 < d ? __ldg(p + 3) : 0.f);
}

// Splits one thread's 4 x 4 values into the big and small panels at row r,
// 16-byte chunk c4 of the row (swizzled: chunk c4 of row r sits at c4 ^ (r % 8)).
__device__ __forceinline__ void store_split(unsigned char* big, unsigned char* small, int r, int c4, float4 v) {
  uint4 b, s;
  split_tf32(v.x, b.x, s.x);
  split_tf32(v.y, b.y, s.y);
  split_tf32(v.z, b.z, s.z);
  split_tf32(v.w, b.w, s.w);
  const int off = r * 128 + ((c4 ^ (r & 7)) << 4);
  *reinterpret_cast<uint4*>(big + off) = b;
  *reinterpret_cast<uint4*>(small + off) = s;
}

__device__ __forceinline__ float sumsq(float acc, float4 v) {
  return fmaf(v.w, v.w, fmaf(v.z, v.z, fmaf(v.y, v.y, fmaf(v.x, v.x, acc))));
}

// The 8 lanes that hold one row's columns (lanes 8q .. 8q+7) sum their parts.
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

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
