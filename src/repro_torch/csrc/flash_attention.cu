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
// end of the key timeline.  A row with no valid key gets 0.
//
// Bound at the prefill shape (B=4, T=S=2048, H=32, KV=8, D=128, bf16): the
// operations.  The causal half is 4*B*H*D*T(T+1)/2 = 137 GFLOP per call
// against 168 MB of q, k, v and o: 0.14 ms on the bf16 tensor cores (989
// TFLOP/s), 0.05 ms of bytes.  So the products go to the tensor cores:
// mma.sync m16n8k16 bf16 x bf16 -> f32.
//
// Design:
//   * One block of 4 warps per (query tile of 64 rows, head, batch); each
//     warp owns 16 rows, so the row max and row sum of the online softmax
//     stay inside a warp (two shuffles).  The sequential kv grid axis of the
//     TPU becomes a loop over 64-key tiles up to the causal diagonal; tiles
//     strictly above it are never loaded.  The tiles with the most keys are
//     scheduled first.
//   * q, k and v are read in place from their strides (no transposes, no
//     copies per head: the GQA group shares k/v through the head index).
//     Ragged T and S are masked here, not padded by the caller.
//   * The state (m, l, acc) stays in f32 registers with the reference's
//     guards: alpha = 0 while m = -inf, p = 0 where s = -inf, and the final
//     divide by l only where l > 0.
//   * Numerics.  bf16 inputs: q.k products are exact in the f32 accumulator,
//     as the reference's f32 upcast makes them.  p is split into two bf16
//     pieces (hi + lo, 16 significant bits) so p.v carries an error of about
//     2^-17 of p instead of bf16's 2^-9.  f32 inputs: each of q, k, v and p
//     is split into three bf16 pieces (24 bits) and the six products of
//     piece pairs (i, j) with i + j < 3 are summed, which keeps f32 accuracy
//     on the tensor cores.
//   * Staging: bf16 tiles go to shared memory by 16-byte cp.async copies
//     (f32 tiles through registers, to be split); every mma operand then
//     comes by ldmatrix, v's transposed on the way (ldmatrix.trans), so no
//     thread stores a transposed tile.  One k/v tile at a time: no
//     double-buffered pipeline, no TMA, no wgmma yet.  Shared memory per
//     block: 51 KB (bf16, D=128), 153 KB (f32, D=128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = 32 * WARPS;
constexpr int PAD = 8;        // bf16 of padding per shared row: conflict-free fragment loads

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
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

// Finite: the exponent bits are not all ones (so neither inf nor NaN).
__device__ __forceinline__ bool finite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o, int B, int Tq, int S,
               int H, int KV, const long long* st, float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Tq, S, H, KV, st, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Tq, S, H, KV, st, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Tq, S, H, KV, st, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Tq, S, H, KV, st, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, T, H, D), k and v (B, S, KV, D) with unit stride over D and the
// element strides of their batch, position and head axes in `strides`
// (q's three, then k's, then v's); o (B, T, H, D) contiguous.  dtype 0 is
// bf16, 1 is f32.  Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int dtype, int B, int Tq, int S, int H, int KV, int D,
                                      const long long* strides, float scale, int causal,
                                      void* stream) {
  if (B <= 0 || Tq <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<bf16>(D, q, k, v, o, B, Tq, S, H, KV, strides, scale, causal, st);
  if (dtype == 1) return dispatch_d<float>(D, q, k, v, o, B, Tq, S, H, KV, strides, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
