// Causal GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py `_flash_kernel` via
// `flash_attention_kernel_call` (the Pallas TPU kernel: grid (B*H, q blocks,
// kv blocks) with the kv axis sequential and the online-softmax state in
// VMEM scratch).
//
// Computes, for q (B, T, H, D) and k, v (B, S, KV, D), query head h reading
// kv head h / (H / KV):
//     o[b, t, h] = softmax_s(scale * q[b, t, h] . k[b, s, h/g]) . v[b, s, h/g]
// over s <= t + (S - T) when causal: the alignment of the reference's oracle
// (`ref.py`) and of `chunked_attention`, so a short query block sits at the
// end of the key timeline.  A row with no valid key gets 0.  q, k and v are
// read in place from their strides (no transposes, no per-head copies: the
// GQA group shares k/v through the head index); o is contiguous.
//
// Bound at the prefill shape (B=4, T=S=2048, H=32, KV=8, D=128, bf16): the
// operations.  The causal half is 4*B*H*D*T(T+1)/2 = 137 GFLOP per call
// against 168 MB of q, k, v and o: 0.14 ms on the bf16 tensor cores (989
// TFLOP/s), 0.05 ms of bytes.  With p split in two (below) the p.v half of
// the products runs twice, so the tensor cores need 1.5 x 0.14 = 0.21 ms.
//
// State and numerics, common to both kernels: (m, l, acc) stay in f32
// registers with the reference's guards (alpha = 0 while m = -inf, p = 0
// where s = -inf, divide by l only where l > 0).  bf16 q.k products are
// exact in the f32 accumulator, as the reference's f32 upcast makes them;
// p is split into two bf16 pieces (hi + lo, 16 significant bits), so p.v
// carries about 2^-17 of p instead of bf16's 2^-9.
//
// Two kernels, chosen by dtype and head_dim alone (the wrapper's `route`):
//
// tma_wgmma: bf16 at D = 64 and 128 (every served config).
//   * One block of three warpgroups per (128-row query tile, head, batch),
//     the tiles with the most keys first.  A producer warpgroup gives up
//     registers (setmaxnreg 24) and one of its threads issues every load;
//     two consumer warpgroups (setmaxnreg 240) own 64 query rows each.
//   * Loads by TMA from 4-D tensor maps built on the host from the strides
//     (D, then position, head and batch by increasing stride), 128-byte
//     swizzle, one 64-column box per swizzle atom (a 256-byte row at D = 128
//     is two atoms).  Q once per block; K and V tiles of 64 keys through a
//     four-stage ring with full/empty mbarriers, so the loads run ahead of
//     the products.  Ragged T and S read as zeros past the end (TMA's
//     out-of-bounds fill); rows past T are not stored.  Tiles strictly above
//     the causal diagonal are never loaded; masks run only on the diagonal
//     tile and the ragged tail.
//   * s = q . k^T by wgmma m64n64k16 with both operands in shared memory
//     (K-major); acc += p . v by wgmma m64nDk16 with p in registers (two
//     products per 16-key step: hi, then lo) and v in shared memory read
//     MN-major through the transpose bit, so no thread transposes a tile.
//   * Overlap, as FlashAttention-3 does it: a warpgroup issues q . k^T of
//     tile j and p . v of tile j - 1 together and runs the softmax of tile j
//     while p . v runs; and the two warpgroups take turns issuing (named
//     barriers, "pingpong"), so one's softmax runs beside the other's
//     products instead of both waiting on the same tile at once.
//   * 64 keys per tile because the p split doubles p's registers: s (32 f32)
//     and the hi and lo fragments of the previous tile (32) in flight with
//     acc (64 at D = 128) is the footprint FlashAttention-3 has at 128 keys
//     with one bf16 p; 128 keys spilled.  Shared memory: 160 KB at D = 128
//     (q 32 KB, four stages of k and v at 16 KB each), 80 KB at D = 64.
//
// mma_sync: f32 at every D, bf16 at D = 16 and 32 (the smoke configs).
//   * One block of 4 warps per (64-row query tile, head, batch); each warp
//     owns 16 rows.  A loop over 64-key tiles up to the causal diagonal,
//     one k/v tile at a time (16-byte cp.async for bf16; f32 through
//     registers, split), mma.sync m16n8k16 bf16 -> f32 with every operand
//     by ldmatrix (v's through ldmatrix.trans).  f32 inputs: each of q, k, v
//     and p is split into three bf16 pieces (24 bits) and the six products
//     of piece pairs (i, j) with i + j < 3 are summed, which keeps f32
//     accuracy on the tensor cores.  Shared memory per block: up to 153 KB
//     (f32, D = 128).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Finite: the exponent bits are not all ones (so neither inf nor NaN).
__device__ __forceinline__ bool finite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

namespace mma_sync {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = 32 * WARPS;
constexpr int PAD = 8;        // bf16 of padding per shared row: conflict-free fragment loads

template <typename T> struct Traits;
template <> struct Traits<bf16> {
  static constexpr int NP = 1;   // bf16 pieces per input value
  static constexpr int VEC = 8;  // elements per 16-byte load
};
template <> struct Traits<float> {
  static constexpr int NP = 3;
  static constexpr int VEC = 4;
};

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 raw = *reinterpret_cast<const float4*>(p);
  out[0] = raw.x; out[1] = raw.y; out[2] = raw.z; out[3] = raw.w;
}

// x = out[0] + out[1] + ... to 8*NP significant bits.
template <int NP>
__device__ __forceinline__ void split(float x, bf16 (&out)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    out[i] = __float2bfloat16_rn(x);
    x -= __bfloat162float(out[i]);
  }
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory into the mma fragment layout;
// lane l gives the address of row l % 8 of matrix l / 8.  With TRANS each
// matrix arrives transposed (v, whose rows are keys, as the B operand).
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// Rows [r0, r0 + ROWS) of one head of a (B, L, heads, D) tensor into shared
// memory as NP bf16 pieces, row-major [NP][ROWS][D + PAD]; rows >= L are
// zeros.  bf16 rows go by 16-byte asynchronous copies (cp.async, zero-fill
// past L) straight to shared memory; f32 rows through registers, split.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* sm, const T* base, long long row_stride, int r0, int L) {
  constexpr int NP = Traits<T>::NP;
  constexpr int VEC = Traits<T>::VEC;
  constexpr int CHUNKS = D / VEC;
  constexpr int LD = D + PAD;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * VEC;
    const bool in = r0 + r < L;
    const T* src = in ? base + (long long)(r0 + r) * row_stride + c : base;
    if constexpr (NP == 1) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(smem_u32(sm + r * LD + c)), "l"(src), "r"(in ? 16 : 0));
    } else {
      float vals[VEC];
      if (in) {
        load_vec(src, vals);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vals[e] = 0.f;
      }
      bf16 pc[VEC][NP];
#pragma unroll
      for (int e = 0; e < VEC; ++e) split<NP>(vals[e], pc[e]);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        uint32_t* dst = reinterpret_cast<uint32_t*>(sm + p * ROWS * LD + r * LD + c);
#pragma unroll
        for (int w = 0; w < VEC / 2; ++w) dst[w] = pack(pc[2 * w][p], pc[2 * w + 1][p]);
      }
    }
  }
  if constexpr (NP == 1) {
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int Tq, int S, int H, int KV,
                 long long qsb, long long qst, long long qsh,
                 long long ksb, long long kst, long long ksh,
                 long long vsb, long long vst, long long vsh,
                 float scale, int causal) {
  constexpr int NP = Traits<T>::NP;
  constexpr int NPP = NP == 1 ? 2 : NP;  // pieces of p in the p.v product
  constexpr int LD = D + PAD;            // row stride of the q, k and v tiles
  constexpr int NT = BK / 8;             // 8-key column tiles of s
  constexpr int DT = D / 8;              // 8-wide column tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [NP][BQ][LD]
  bf16* ks = qs + NP * BQ * LD;              // [NP][BK][LD]
  bf16* vs = ks + NP * BK * LD;              // [NP][BK][LD]

  const float NEG_INF = __int_as_float(0xff800000);
  const int qi = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qi * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row within the warp's 16
  const int tg = lane & 3;   // fragment column pair
  const int off = S - Tq;    // query t sits at key position t + off
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  const int lm = lane >> 3;  // the 8x8 matrix whose row this lane addresses in ldsm_x4
  const int lr = lane & 7;   // and the row

  load_tile<T, D, BQ>(qs, q + b * qsb + h * qsh, qst, q0, Tq);

  const int last_row = min(q0 + BQ, Tq) - 1;
  const int k_end = causal ? min(S, last_row + off + 1) : S;  // keys [0, k_end) are visited
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile is consumed
    load_tile<T, D, BK>(ks, k + b * ksb + kvh * ksh, kst, k0, S);
    load_tile<T, D, BK>(vs, v + b * vsb + kvh * vsh, vst, k0, S);
    __syncthreads();

    // s = q . k^T for this warp's 16 rows and the tile's 64 keys.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
#pragma unroll
      for (int pq = 0; pq < NP; ++pq) {
        // a: rows 0-7 / 8-15 of the warp's 16 (matrix bit 0) x columns 0-7 / 8-15 (bit 1)
        uint32_t a[4];
        ldsm_x4<false>(a, qs + pq * BQ * LD + (warp * 16 + (lm & 1) * 8 + lr) * LD + kd * 16 + (lm >> 1) * 8);
#pragma unroll
        for (int pk = 0; pk + pq < NP; ++pk) {
#pragma unroll
          for (int nt = 0; nt < NT; nt += 2) {
            // b of key tiles nt (matrices 0, 1) and nt + 1 (2, 3), each as d 0-7 and 8-15
            uint32_t kb[4];
            ldsm_x4<false>(kb, ks + pk * BK * LD + ((nt + (lm >> 1)) * 8 + lr) * LD + kd * 16 + (lm & 1) * 8);
            mma(s[nt], a, kb[0], kb[1]);
            mma(s[nt + 1], a, kb[2], kb[3]);
          }
        }
      }
    }

    // Scale, mask, and fold the tile into the online softmax.
    const bool mask = (k0 + BK > S) || (causal && k0 + BK - 1 > q0 + off);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * tg + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        float x = s[nt][e] * scale;
        if (mask && (col >= S || (causal && col > row + off))) x = NEG_INF;
        s[nt][e] = x;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = finite(m[r]) ? expf(m[r] - m_new) : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = finite(s[nt][e]) ? expf(s[nt][e] - m_new) : 0.f;
          s[nt][e] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt][2 * r] *= alpha;
        acc[dt][2 * r + 1] *= alpha;
      }
    }

    // acc += p . v.  The s accumulators of two neighbouring 8-key tiles are
    // the A fragment of one 16-key step.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const float pv[4][2] = {
          {s[2 * kk][0], s[2 * kk][1]}, {s[2 * kk][2], s[2 * kk][3]},
          {s[2 * kk + 1][0], s[2 * kk + 1][1]}, {s[2 * kk + 1][2], s[2 * kk + 1][3]}};
      uint32_t pa[NPP][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bf16 lo[NPP], hi[NPP];
        split<NPP>(pv[i][0], lo);
        split<NPP>(pv[i][1], hi);
#pragma unroll
        for (int p = 0; p < NPP; ++p) pa[p][i] = pack(lo[p], hi[p]);
      }
#pragma unroll
      for (int pw = 0; pw < NP; ++pw) {
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          // b of output columns dt (matrices 0, 1) and dt + 1 (2, 3), each as
          // keys 0-7 and 8-15 of this step, transposed from v's rows
          uint32_t vb[4];
          ldsm_x4<true>(vb, vs + pw * BK * LD + (kk * 16 + (lm & 1) * 8 + lr) * LD + (dt + (lm >> 1)) * 8);
#pragma unroll
          for (int pp = 0; pp + pw < NPP; ++pp) {
            mma(acc[dt], pa[pp], vb[0], vb[1]);
            mma(acc[dt + 1], pa[pp], vb[2], vb[3]);
          }
        }
      }
    }
  }

  // o = acc / l where l > 0 (a row with no valid key keeps acc = 0).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= Tq) continue;
    const float safe = l[r] > 0.f ? l[r] : 1.f;
    T* orow = o + (((long long)b * Tq + row) * H + h) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      store2(orow + dt * 8 + 2 * tg, acc[dt][2 * r] / safe, acc[dt][2 * r + 1] / safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Tq, int S, int H,
           int KV, const long long* st, float scale, int causal, cudaStream_t stream) {
  constexpr int NP = Traits<T>::NP;
  const size_t smem = sizeof(bf16) * NP * (BQ + 2 * BK) * (D + PAD);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Tq, S, H, KV, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale, causal);
  return (int)cudaGetLastError();
}

// bf16 at head_dim 64 and 128 takes tma_wgmma: this kernel has no instance there.
int dispatch(int dtype, int D, const void* q, const void* k, const void* v, void* o, int B, int Tq,
             int S, int H, int KV, const long long* st, float scale, int causal, cudaStream_t stream) {
  if (dtype == 0 && D == 16) return launch<bf16, 16>(q, k, v, o, B, Tq, S, H, KV, st, scale, causal, stream);
  if (dtype == 0 && D == 32) return launch<bf16, 32>(q, k, v, o, B, Tq, S, H, KV, st, scale, causal, stream);
  if (dtype == 1 && D == 16) return launch<float, 16>(q, k, v, o, B, Tq, S, H, KV, st, scale, causal, stream);
  if (dtype == 1 && D == 32) return launch<float, 32>(q, k, v, o, B, Tq, S, H, KV, st, scale, causal, stream);
  if (dtype == 1 && D == 64) return launch<float, 64>(q, k, v, o, B, Tq, S, H, KV, st, scale, causal, stream);
  if (dtype == 1 && D == 128) return launch<float, 128>(q, k, v, o, B, Tq, S, H, KV, st, scale, causal, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mma_sync

namespace tma_wgmma {

constexpr int BQ = 128;         // query rows per block: two consumer warpgroups of 64
constexpr int BK = 64;          // keys per tile
constexpr int STAGES = 4;       // k/v tiles in flight
constexpr int CONSUMERS = 256;  // threads of the two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;
constexpr int ATOM = 128;       // bytes of one row of a 64-column half: one 128-byte swizzle atom

struct Params {
  int Tq, S, KV, causal;
  float scale;
  int qslot[3], kslot[3], vslot[3];  // tensor-map dimension (1-3) of position, head, batch
};

// ---- mbarriers, TMA, wgmma (PTX for sm_90a)

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
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

__device__ __forceinline__ int coord(const int (&slot)[3], int dim, int pos, int head, int batch) {
  return slot[0] == dim ? pos : slot[1] == dim ? head : batch;
}

// One box (64 columns from `col`, the map's rows from `pos`, one head, one
// batch) into shared memory; the barrier counts its bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map, uint64_t* bar, int col,
                                         const int (&slot)[3], int pos, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_u32(bar)), "r"(col),
         "r"(coord(slot, 1, pos, head, batch)), "r"(coord(slot, 2, pos, head, batch)),
         "r"(coord(slot, 3, pos, head, batch))
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile whose rows
// are 128 bytes: SBO is the stride of 8-row groups (1024 bytes), LBO the
// stride of 64-column groups (used by the MN-major v operand at D = 128).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo_bytes) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16 |
         (uint64_t)(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>  // waits until at most N committed groups are still running
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory"); }

// Keeps the compiler from moving reads or writes of wgmma registers across
// the asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][2][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][j][e]) :: "memory");
}

// d (64 x 64, f32) = a (64 x 16) . b (64 x 16)^T + (scale_d ? d : 0); both operands
// in shared memory, K-major, 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, f32) += a (64 x 16, registers) . b (16 x 64); b in shared memory,
// MN-major (the transpose bit), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, f32) += a (64 x 16, registers) . b (16 x 128); b in shared memory,
// MN-major (the transpose bit), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n64(d, a, b); }
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n128(d, a, b); }

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(CONSUMERS) : "memory");
}

// s = q . k^T for one warpgroup's 64 rows and a tile of 64 keys: D / 16
// products along d, each inside one 64-column swizzle atom.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], const unsigned char* q_wg, const unsigned char* k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int hf = kk / 4, byte = (kk % 4) * 32;
    wgmma_ss_n64(s, sw128_desc(q_wg + hf * BQ * ATOM + byte, 16),
                 sw128_desc(k_tile + hf * BK * ATOM + byte, 16), kk > 0);
  }
  wgmma_commit();
}

// acc += p . v for a tile of 64 keys: v's rows are keys (MN-major for the
// product), read through the transpose bit; hi, then lo at each 16-key step.
template <int NO>
__device__ __forceinline__ void issue_pv(float (&acc)[NO], const uint32_t (&pa)[BK / 16][2][4],
                                         const unsigned char* v_tile) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = sw128_desc(v_tile + kk * 16 * ATOM, BK * ATOM);
    wgmma_rs(acc, pa[kk][0], dv);
    wgmma_rs(acc, pa[kk][1], dv);
  }
  wgmma_commit();
}

// Scales s, masks it (only on the diagonal tile and the ragged tail), folds
// the tile into the row state (m, l) and leaves p = exp(s - m) in s; alpha
// is the factor that rescales the rows' acc.  The arithmetic is the plain
// version's, step for step: x = s * scale rounded to f32, then exp(x - m).
__device__ __forceinline__ void softmax(float (&s)[BK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                        int S, int causal, int off, int k0, int wg_row0, int row0, int tg,
                                        float scale) {
  const float NEG_INF = __int_as_float(0xff800000);
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] *= scale;
  if ((k0 + BK > S) || (causal && k0 + BK - 1 > wg_row0 + off)) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int col = k0 + (i / 4) * 8 + 2 * tg + (i & 1);
      const int row = row0 + ((i >> 1) & 1) * 8;
      if (col >= S || (causal && col > row + off)) s[i] = NEG_INF;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt * 4 + 2 * r], s[nt * 4 + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    alpha[r] = finite(m[r]) ? expf(m[r] - m_new) : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float pv = finite(s[nt * 4 + e]) ? expf(s[nt * 4 + e] - m_new) : 0.f;
        s[nt * 4 + e] = pv;
        sum += pv;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[r] = l[r] * alpha[r] + sum;
    m[r] = m_new;
  }
}

// p = hi + lo, two bf16 pieces.  The accumulators of two neighbouring 8-key
// column blocks are the A fragment of one 16-key step.
__device__ __forceinline__ void to_pieces(const float (&s)[BK / 2], uint32_t (&pa)[BK / 16][2][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = s[kk * 8 + 2 * i], c = s[kk * 8 + 2 * i + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
      const float2 hf = __bfloat1622float2(hi);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(a - hf.x, c - hf.y);
      pa[kk][0][i] = *reinterpret_cast<const uint32_t*>(&hi);
      pa[kk][1][i] = *reinterpret_cast<const uint32_t*>(&lo);
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o, const Params p) {
  constexpr int HALVES = D / 64;           // 64-column halves of a row, one swizzle atom each
  constexpr int Q_BYTES = BQ * D * 2;
  constexpr int KV_BYTES = BK * D * 2;
  constexpr int NO = D / 2;                // o accumulators per consumer thread
  constexpr int NS = BK / 2;               // s accumulators per consumer thread
  __shared__ __align__(8) uint64_t q_full, k_full[STAGES], k_empty[STAGES], v_full[STAGES], v_empty[STAGES];
  extern __shared__ unsigned char smem_raw[];
  // The swizzle pattern repeats every 1024 bytes: every tile starts on such a boundary.
  unsigned char* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // [HALVES][BQ][64]
  unsigned char* ks = qs + Q_BYTES;              // [STAGES][HALVES][BK][64]
  unsigned char* vs = ks + STAGES * KV_BYTES;    // [STAGES][HALVES][BK][64]

  const float NEG_INF = __int_as_float(0xff800000);
  const int qi = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (gridDim.y / p.KV);
  const int q0 = qi * BQ;
  const int off = p.S - p.Tq;  // query t sits at key position t + off
  const int last_row = min(q0 + BQ, p.Tq) - 1;
  const int k_end = p.causal ? min(p.S, last_row + off + 1) : p.S;  // keys [0, k_end) are visited
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], CONSUMERS);
      mbar_init(&v_empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // Producer warpgroup: one thread keeps the ring of k/v tiles full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(&q_full, Q_BYTES);
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf)
        tma_load(qs + hf * BQ * ATOM, qmap, &q_full, hf * 64, p.qslot, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const uint32_t ph = (j / STAGES) & 1;
        mbar_wait(&k_empty[s], ph ^ 1);  // the first round finds every stage free
        mbar_expect_tx(&k_full[s], KV_BYTES);
#pragma unroll
        for (int hf = 0; hf < HALVES; ++hf)
          tma_load(ks + s * KV_BYTES + hf * BK * ATOM, kmap, &k_full[s], hf * 64, p.kslot, j * BK, kvh, b);
        mbar_wait(&v_empty[s], ph ^ 1);
        mbar_expect_tx(&v_full[s], KV_BYTES);
#pragma unroll
        for (int hf = 0; hf < HALVES; ++hf)
          tma_load(vs + s * KV_BYTES + hf * BK * ATOM, vmap, &v_full[s], hf * 64, p.vslot, j * BK, kvh, b);
      }
    }
  } else {
    // Consumer warpgroups: 64 query rows each, 16 per warp.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int tg = lane & 3;  // accumulator column pair
    const int wg_row0 = q0 + wg * 64;
    const int row0 = wg_row0 + warp * 16 + (lane >> 2);  // this thread's rows: row0 and row0 + 8
    const unsigned char* q_wg = qs + wg * 64 * ATOM;
    // Pingpong: the two warpgroups take turns issuing their products (named
    // barriers 1 and 2), so one's softmax runs beside the other's products.
    const int my_turn = 1 + wg, their_turn = 2 - wg;

    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};
    float alpha[2];
    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    float s[NS];                 // s of tile j, then p of tile j
    uint32_t pa[BK / 16][2][4];  // p of tile j - 1 as A fragments: [16-key step][hi, lo][register]

    mbar_wait(&q_full, 0);
    if (n_tiles > 0) {
      if (wg == 1) bar_arrive(1);  // warpgroup 0 goes first
      mbar_wait(&k_full[0], 0);
      bar_sync(my_turn);
      wgmma_fence();
      issue_qk<D>(s, q_wg, ks);
      bar_arrive(their_turn);
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(&k_empty[0]);
      softmax(s, m, l, alpha, p.S, p.causal, off, 0, wg_row0, row0, tg, p.scale);
      to_pieces(s, pa);
    }
    // Tile j: q.k^T of tile j and p.v of tile j - 1 in flight together, the
    // softmax of tile j beside p.v, then acc rescaled and p of j split.
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % STAGES, pst = (j - 1) % STAGES;
      const uint32_t ph = (j / STAGES) & 1, pph = ((j - 1) / STAGES) & 1;
      mbar_wait(&k_full[st], ph);
      bar_sync(my_turn);
      fence_regs(s);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      issue_qk<D>(s, q_wg, ks + st * KV_BYTES);
      mbar_wait(&v_full[pst], pph);
      issue_pv(acc, pa, vs + pst * KV_BYTES);
      bar_arrive(their_turn);
      wgmma_wait<1>();  // q.k^T done, p.v may still run
      fence_regs(s);
      mbar_arrive(&k_empty[st]);
      softmax(s, m, l, alpha, p.S, p.causal, off, j * BK, wg_row0, row0, tg, p.scale);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(&v_empty[pst]);
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i >> 1) & 1];
      to_pieces(s, pa);
    }
    if (n_tiles > 0) {
      const int pst = (n_tiles - 1) % STAGES;
      mbar_wait(&v_full[pst], ((n_tiles - 1) / STAGES) & 1);
      bar_sync(my_turn);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      issue_pv(acc, pa, vs + pst * KV_BYTES);
      if (wg == 0) bar_arrive(their_turn);  // warpgroup 1 takes the last turn
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(&v_empty[pst]);
    }

    // o = acc / l where l > 0 (a row with no valid key keeps acc = 0).
    const int H = gridDim.y;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (row >= p.Tq) continue;
      const float safe = l[r] > 0.f ? l[r] : 1.f;
      bf16* orow = o + (((long long)b * p.Tq + row) * H + h) * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        store2(orow + dt * 8 + 2 * tg, acc[dt * 4 + 2 * r] / safe, acc[dt * 4 + 2 * r + 1] / safe);
    }
  }
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

// A 4-D map over one (B, L, heads, D) bf16 tensor with element strides
// st = (batch, position, head) and unit stride over D.  Dimension 0 is D
// with a box of 64 columns (one swizzle atom); dimensions 1-3 are position
// (box `rows`), head and batch (box 1) in increasing order of stride, and
// slot[e] records where entity e (position, head, batch) went.  Rows past L
// read as zeros.
int make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int D, int L, int heads, int B,
             const long long* st, int rows, int (&slot)[3]) {
  const long long ext[3] = {L, heads, B};
  const long long str[3] = {st[1], st[2], st[0]};
  const cuuint32_t box[3] = {(cuuint32_t)rows, 1, 1};
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && str[order[j]] < str[order[j - 1]]; --j) {
      const int tmp = order[j];
      order[j] = order[j - 1];
      order[j - 1] = tmp;
    }
  cuuint64_t dims[4] = {(cuuint64_t)D, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t boxes[4] = {64, 0, 0, 0};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    const int e = order[i];
    slot[e] = i + 1;
    dims[i + 1] = (cuuint64_t)ext[e];
    // An axis of extent 1 is never stepped along; its stride only has to be valid.
    strides[i] = (cuuint64_t)(ext[e] == 1 && str[e] * 2 < 16 ? 16 : str[e] * 2);
    boxes[i + 1] = box[e];
  }
  return (int)enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, boxes,
                  unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Tq, int S, int H, int KV,
           const long long* st, float scale, int causal, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  Params p;
  if (make_map(enc, &qm, q, D, Tq, H, B, st, BQ, p.qslot) != 0 ||
      make_map(enc, &km, k, D, S, KV, B, st + 3, BK, p.kslot) != 0 ||
      make_map(enc, &vm, v, D, S, KV, B, st + 6, BK, p.vslot) != 0)
    return (int)cudaErrorInvalidValue;
  p.Tq = Tq;
  p.S = S;
  p.KV = KV;
  p.causal = causal;
  p.scale = scale;
  const size_t smem = 1024 + (size_t)BQ * D * 2 + 2 * (size_t)STAGES * BK * D * 2;  // + alignment slack
  auto kern = flash_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(qm, km, vm, static_cast<bf16*>(o), p);
  return (int)cudaGetLastError();
}

}  // namespace tma_wgmma

}  // namespace

// q (B, T, H, D), k and v (B, S, KV, D) with unit stride over D and the
// element strides of their batch, position and head axes in `strides`
// (q's three, then k's, then v's); o (B, T, H, D) contiguous.  dtype 0 is
// bf16, 1 is f32.  Both entry points return the CUDA error of the launch (0
// on success); each refuses the dtypes and widths the other one takes.
//
// The mma_sync kernel: f32 at D in {16, 32, 64, 128}, bf16 at D in {16, 32}.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int dtype, int B, int Tq, int S, int H, int KV, int D,
                                      const long long* strides, float scale, int causal,
                                      void* stream) {
  if (B <= 0 || Tq <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  return mma_sync::dispatch(dtype, D, q, k, v, o, B, Tq, S, H, KV, strides, scale, causal,
                            static_cast<cudaStream_t>(stream));
}

// The tma_wgmma kernel: bf16 at D in {64, 128}; every stride a multiple of
// 8 elements and the starts 16-byte aligned (TMA's rules).
extern "C" int flash_attention_tma_launch(const void* q, const void* k, const void* v, void* o,
                                          int dtype, int B, int Tq, int S, int H, int KV, int D,
                                          const long long* strides, float scale, int causal,
                                          void* stream) {
  if (B <= 0 || Tq <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || B > 65535 || H > 65535 || dtype != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return tma_wgmma::launch<64>(q, k, v, o, B, Tq, S, H, KV, strides, scale, causal, st);
  if (D == 128) return tma_wgmma::launch<128>(q, k, v, o, B, Tq, S, H, KV, strides, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
