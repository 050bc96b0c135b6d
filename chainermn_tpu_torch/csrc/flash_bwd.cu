// Flash-attention backward for Hopper (sm_90a), plain CUDA C++ behind a C ABI.
//
// Replaces: chainermn_tpu/ops/flash_attention.py :: _bwd_fused_kernel (the
// pallas_call in _bwd_pallas).  Same function: dq, dk, dv from q, k, v, dO,
// the forward's LSE and delta = rowsum(dO*O) - dlse (computed outside, as
// JAX does), recomputing p = exp(s - lse) tile by tile so no (S, S) score
// matrix exists.  JAX's rounding is kept: p is rounded to dO's dtype before
// the dv product, ds = p*(dp - delta)*scale to q's dtype before dk and to
// k's dtype before dq; every sum is fp32.  GQA: dk and dv of one KV head are
// summed over its `group` q heads in fp32, never expanded.  The ragged tail
// past S is masked here instead of padded; causal cells above the diagonal
// are never visited.
//
// Bound on this card: at the training shape (B 8, S 1024, H 8, hd 128,
// bf16, causal) the function reads q, k, v, O, dO once and writes dq, dk,
// dv (~134 MB, 0.040 ms at 3.35 TB/s) and does five (S x S/2 x hd) products,
// 4.3e10 FLOP, 0.044 ms on the bf16 tensor cores: it is bound by
// operations.  Design: the TPU kernel writes dq as per-K-block partials
// summed outside, because its grid is K-major; blocks on Hopper run in no
// order, so the work is split into two launches, each of which owns its
// output rows and needs neither atomics nor partials (deterministic):
//
//   dkdv: one block per (b*h_kv, key tile); it walks the group's q heads and
//         the q tiles from the diagonal on, accumulating dk and dv in fp32.
//   dq:   one block per (b*h, q tile); it walks the key tiles up to the
//         diagonal, accumulating dq in fp32.  dq is rounded once at the end
//         (JAX rounds one partial per 2048-key block, which is the same
//         rounding for S <= 2048).
//
// bf16 inputs run both launches on the tensor cores (mma.sync.m16n8k16,
// fp32 accumulation): four warps own 64 rows, 16 each, and the streamed
// operand comes in 64-row bf16 tiles in padded shared memory; the score
// fragments become the next product's A operand in registers, and the bf16
// packing there is JAX's rounding.  fp32 inputs run on the CUDA cores in
// fp32: 32 rows per block, eight threads per row holding an eighth of the
// row and of its accumulators in registers, dot products summed with three
// shuffles, the streamed operand staged in shared memory as fp32.  wgmma
// and TMA are this kernel's next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TPR = 8;          // threads per row
constexpr int ROWS = 32;        // rows owned by a block
constexpr int TILE = 32;        // rows of the streamed operand per shared tile
constexpr int NT = ROWS * TPR;  // threads per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back (x.astype(T) in fp32 arithmetic)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

// Thread `sub` of a row owns head dims (c*TPR + sub)*4 + e for chunk c and
// e in [0, 4): the eight threads of a row read neighbouring float4s.
template <int D> __device__ __forceinline__ int dim_of(int c, int sub, int e) {
  return (c * TPR + sub) * 4 + e;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int S,
    int H, int group, float scale, int causal) {
  constexpr int CH = D / (TPR * 4);
  __shared__ __align__(16) float qs[TILE][D];
  __shared__ __align__(16) float dos[TILE][D];
  __shared__ float lse_s[TILE];
  __shared__ float delta_s[TILE];

  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int sub = tid % TPR;
  const int k0 = blockIdx.x * ROWS;
  const int hkv_n = H / group;
  const int b = blockIdx.y / hkv_n;
  const int hkv = blockIdx.y % hkv_n;
  const int kj = k0 + r;
  const bool key_ok = kj < S;

  const size_t kv_base = (((size_t)b * S + kj) * hkv_n + hkv) * D;
  float kr[CH][4], vr[CH][4], dka[CH][4], dva[CH][4];
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = dim_of<D>(c, sub, e);
      kr[c][e] = key_ok ? to_f(k[kv_base + d]) : 0.f;
      vr[c][e] = key_ok ? to_f(v[kv_base + d]) : 0.f;
      dka[c][e] = 0.f;
      dva[c][e] = 0.f;
    }

  // under causal masking no q row above the block's first key contributes
  const int i_begin = causal ? k0 : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hkv * group + g;
    const size_t row_stats = ((size_t)b * H + h) * S;
    for (int i0 = i_begin; i0 < S; i0 += TILE) {
      __syncthreads();  // the previous tile is consumed
      for (int idx = tid; idx < TILE * D; idx += NT) {
        const int i = idx / D;
        const int d = idx % D;
        const int qi = i0 + i;
        float qv = 0.f, dov = 0.f;
        if (qi < S) {
          const size_t off = (((size_t)b * S + qi) * H + h) * D + d;
          qv = to_f(q[off]);
          dov = to_f(dout[off]);
        }
        qs[i][d] = qv;
        dos[i][d] = dov;
      }
      if (tid < TILE) {
        const int qi = i0 + tid;
        lse_s[tid] = qi < S ? lse[row_stats + qi] : 0.f;
        delta_s[tid] = qi < S ? delta[row_stats + qi] : 0.f;
      }
      __syncthreads();

#pragma unroll 2
      for (int i = 0; i < TILE; ++i) {
        const int qi = i0 + i;
        float sp = 0.f, dpp = 0.f;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const float4 qq = *reinterpret_cast<const float4*>(&qs[i][dim_of<D>(c, sub, 0)]);
          const float4 dd = *reinterpret_cast<const float4*>(&dos[i][dim_of<D>(c, sub, 0)]);
          sp += qq.x * kr[c][0] + qq.y * kr[c][1] + qq.z * kr[c][2] + qq.w * kr[c][3];
          dpp += dd.x * vr[c][0] + dd.y * vr[c][1] + dd.z * vr[c][2] + dd.w * vr[c][3];
        }
        sp = row_sum(sp);
        dpp = row_sum(dpp);
        const bool ok = key_ok && qi < S && (!causal || kj <= qi);
        const float p = ok ? expf(sp * scale - lse_s[i]) : 0.f;
        const float pr = round_to<T>(p);                                 // p.astype(do.dtype)
        const float dsr = round_to<T>(p * (dpp - delta_s[i]) * scale);   // ds.astype(q.dtype)
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const float4 qq = *reinterpret_cast<const float4*>(&qs[i][dim_of<D>(c, sub, 0)]);
          const float4 dd = *reinterpret_cast<const float4*>(&dos[i][dim_of<D>(c, sub, 0)]);
          dva[c][0] += pr * dd.x;
          dva[c][1] += pr * dd.y;
          dva[c][2] += pr * dd.z;
          dva[c][3] += pr * dd.w;
          dka[c][0] += dsr * qq.x;
          dka[c][1] += dsr * qq.y;
          dka[c][2] += dsr * qq.z;
          dka[c][3] += dsr * qq.w;
        }
      }
    }
  }

  if (key_ok) {
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = dim_of<D>(c, sub, e);
        dk[kv_base + d] = from_f<T>(dka[c][e]);
        dv[kv_base + d] = from_f<T>(dva[c][e]);
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int S, int H, int group,
    float scale, int causal) {
  constexpr int CH = D / (TPR * 4);
  __shared__ __align__(16) float ks[TILE][D];
  __shared__ __align__(16) float vs[TILE][D];

  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int sub = tid % TPR;
  const int q0 = blockIdx.x * ROWS;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hkv_n = H / group;
  const int hkv = h / group;
  const int qi = q0 + r;
  const bool row_ok = qi < S;

  const size_t q_base = (((size_t)b * S + qi) * H + h) * D;
  float qr[CH][4], dor[CH][4], dqa[CH][4];
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = dim_of<D>(c, sub, e);
      qr[c][e] = row_ok ? to_f(q[q_base + d]) : 0.f;
      dor[c][e] = row_ok ? to_f(dout[q_base + d]) : 0.f;
      dqa[c][e] = 0.f;
    }
  const float lse_i = row_ok ? lse[(size_t)bh * S + qi] : 0.f;
  const float delta_i = row_ok ? delta[(size_t)bh * S + qi] : 0.f;

  const int k_end = causal ? min(S, q0 + ROWS) : S;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < TILE * D; idx += NT) {
      const int j = idx / D;
      const int d = idx % D;
      const int kj = k0 + j;
      float kv_k = 0.f, kv_v = 0.f;
      if (kj < S) {
        const size_t off = (((size_t)b * S + kj) * hkv_n + hkv) * D + d;
        kv_k = to_f(k[off]);
        kv_v = to_f(v[off]);
      }
      ks[j][d] = kv_k;
      vs[j][d] = kv_v;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < TILE; ++j) {
      const int kj = k0 + j;
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][dim_of<D>(c, sub, 0)]);
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][dim_of<D>(c, sub, 0)]);
        sp += qr[c][0] * kk.x + qr[c][1] * kk.y + qr[c][2] * kk.z + qr[c][3] * kk.w;
        dpp += dor[c][0] * vv.x + dor[c][1] * vv.y + dor[c][2] * vv.z + dor[c][3] * vv.w;
      }
      sp = row_sum(sp);
      dpp = row_sum(dpp);
      const bool ok = row_ok && kj < S && (!causal || kj <= qi);
      const float p = ok ? expf(sp * scale - lse_i) : 0.f;
      const float dsr = round_to<T>(p * (dpp - delta_i) * scale);  // ds.astype(k.dtype)
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][dim_of<D>(c, sub, 0)]);
        dqa[c][0] += dsr * kk.x;
        dqa[c][1] += dsr * kk.y;
        dqa[c][2] += dsr * kk.z;
        dqa[c][3] += dsr * kk.w;
      }
    }
  }

  if (row_ok) {
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dq[q_base + dim_of<D>(c, sub, e)] = from_f<T>(dqa[c][e]);
  }
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores: the same two launches with mma.sync.m16n8k16 (bf16
// inputs, fp32 accumulation).  A block of four warps owns 64 rows (keys in
// dkdv, queries in dq), 16 per warp; the streamed operand comes in 64-row
// tiles.  Tiles live in shared memory as bf16 rows padded by 8 elements, so
// the fragment loads of a warp hit distinct banks.  Score fragments are
// turned into the A operand of the next product in registers; JAX's
// roundings (p to dO's dtype, ds to q's / k's) are the bf16 packing.
// ---------------------------------------------------------------------------

constexpr int MBM = 64;            // rows per tile
constexpr int MNT = 128;           // four warps

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* lo, const bf16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

// A[m][k] = X[r0 + m][k0 + k]  (16 x 16)
template <int L>
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* X, int r0, int k0, int g, int t) {
  a[0] = ld32(X + (r0 + g) * L + k0 + 2 * t);
  a[1] = ld32(X + (r0 + g + 8) * L + k0 + 2 * t);
  a[2] = ld32(X + (r0 + g) * L + k0 + 2 * t + 8);
  a[3] = ld32(X + (r0 + g + 8) * L + k0 + 2 * t + 8);
}

// B[k][n] = Y[n0 + n][k0 + k]  (16 x 8): Y holds the n index in its rows
template <int L>
__device__ __forceinline__ void frag_b(uint32_t b[2], const bf16* Y, int n0, int k0, int g, int t) {
  b[0] = ld32(Y + (n0 + g) * L + k0 + 2 * t);
  b[1] = ld32(Y + (n0 + g) * L + k0 + 2 * t + 8);
}

// B[k][n] = Z[k0 + k][n0 + n]  (16 x 8): Z holds the k index in its rows
template <int L>
__device__ __forceinline__ void frag_bt(uint32_t b[2], const bf16* Z, int k0, int n0, int g, int t) {
  b[0] = ld_pair(Z + (k0 + 2 * t) * L + n0 + g, Z + (k0 + 2 * t + 1) * L + n0 + g);
  b[1] = ld_pair(Z + (k0 + 2 * t + 8) * L + n0 + g, Z + (k0 + 2 * t + 9) * L + n0 + g);
}

// rows [s0, s0 + 64) of head `h` of a (B, S, n_heads, D) tensor into a padded
// shared tile, zeros past S
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int b, int s0,
                                          int h, int n_heads, int S) {
  constexpr int L = D + 8;
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < MBM * CHUNKS; idx += MNT) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    const int s = s0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S)
      val = *reinterpret_cast<const uint4*>(src + (((size_t)b * S + s) * n_heads + h) * D + c * 8);
    *reinterpret_cast<uint4*>(dst + r * L + c * 8) = val;
  }
}

// C fragments of a 16-row x (8*NJ)-column score tile → A fragments over its
// columns (k = columns, 16 per fragment)
template <int NJ>
__device__ __forceinline__ void to_a(uint32_t a[NJ / 2][4], const float c[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    a[j / 2][(j % 2) * 2] = pack_bf16(c[j][0], c[j][1]);
    a[j / 2][(j % 2) * 2 + 1] = pack_bf16(c[j][2], c[j][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(MNT) flash_bwd_dkdv_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
    int H, int group, float scale, int causal) {
  constexpr int L = D + 8;
  constexpr int NQ = 4;          // 8-query column tiles per half (32 queries)
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + MBM * L;
  bf16* Qs = Vs + MBM * L;
  bf16* Os = Qs + MBM * L;      // dO
  float* lse_s = reinterpret_cast<float*>(Os + MBM * L);
  float* delta_s = lse_s + MBM;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * MBM;
  const int hkv_n = H / group;
  const int b = blockIdx.y / hkv_n;
  const int hkv = blockIdx.y % hkv_n;
  const int key_lo = k0 + warp * 16 + g;

  load_tile<D>(Ks, k, b, k0, hkv, hkv_n, S);
  load_tile<D>(Vs, v, b, k0, hkv, hkv_n, S);
  float dka[D / 8][4] = {}, dva[D / 8][4] = {};

  const int i_begin = causal ? k0 : 0;
  for (int gi = 0; gi < group; ++gi) {
    const int h = hkv * group + gi;
    const size_t row_stats = ((size_t)b * H + h) * S;
    for (int i0 = i_begin; i0 < S; i0 += MBM) {
      __syncthreads();  // the previous tile is consumed
      load_tile<D>(Qs, q, b, i0, h, H, S);
      load_tile<D>(Os, dout, b, i0, h, H, S);
      if (threadIdx.x < MBM) {
        const int qi = i0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < S ? lse[row_stats + qi] : 0.f;
        delta_s[threadIdx.x] = qi < S ? delta[row_stats + qi] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c0 = half * 32;  // first query column of this half
        float s[NQ][4] = {}, dp[NQ][4] = {};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t ak[4], av[4];
          frag_a<L>(ak, Ks, warp * 16, kk * 16, g, t);
          frag_a<L>(av, Vs, warp * 16, kk * 16, g, t);
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            uint32_t bq[2], bo[2];
            frag_b<L>(bq, Qs, c0 + j * 8, kk * 16, g, t);
            frag_b<L>(bo, Os, c0 + j * 8, kk * 16, g, t);
            mma_bf16(s[j], ak, bq);     // s^T = k q^T
            mma_bf16(dp[j], av, bo);    // dp^T = v dO^T
          }
        }
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key_lo + (e >> 1) * 8;
            const int col = c0 + j * 8 + 2 * t + (e & 1);
            const int query = i0 + col;
            const bool ok = key < S && query < S && (!causal || key <= query);
            const float p = ok ? expf(s[j][e] * scale - lse_s[col]) : 0.f;
            dp[j][e] = p * (dp[j][e] - delta_s[col]) * scale;  // ds^T
            s[j][e] = p;                                        // p^T
          }
        uint32_t ap[NQ / 2][4], ads[NQ / 2][4];
        to_a<NQ>(ap, s);      // p.astype(do.dtype)
        to_a<NQ>(ads, dp);    // ds.astype(q.dtype)
#pragma unroll
        for (int jj = 0; jj < NQ / 2; ++jj)
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            uint32_t bo[2], bq[2];
            frag_bt<L>(bo, Os, c0 + jj * 16, n * 8, g, t);
            frag_bt<L>(bq, Qs, c0 + jj * 16, n * 8, g, t);
            mma_bf16(dva[n], ap[jj], bo);    // dv += p^T dO
            mma_bf16(dka[n], ads[jj], bq);   // dk += ds^T q
          }
      }
    }
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int key = key_lo + hi * 8;
    if (key >= S) continue;
    const size_t base = (((size_t)b * S + key) * hkv_n + hkv) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int d = n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dk + base + d) = pack_bf16(dka[n][2 * hi], dka[n][2 * hi + 1]);
      *reinterpret_cast<uint32_t*>(dv + base + d) = pack_bf16(dva[n][2 * hi], dva[n][2 * hi + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(MNT) flash_bwd_dq_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int S, int H, int group,
    float scale, int causal) {
  constexpr int L = D + 8;
  constexpr int NK = MBM / 8;    // 8-key column tiles per key tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + MBM * L;      // dO
  bf16* Ks = Os + MBM * L;
  bf16* Vs = Ks + MBM * L;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * MBM;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hkv_n = H / group, hkv = h / group;
  const int row_lo = q0 + warp * 16 + g;

  load_tile<D>(Qs, q, b, q0, h, H, S);
  load_tile<D>(Os, dout, b, q0, h, H, S);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = row_lo + hi * 8;
    lse_r[hi] = r < S ? lse[(size_t)bh * S + r] : 0.f;
    delta_r[hi] = r < S ? delta[(size_t)bh * S + r] : 0.f;
  }
  float dqa[D / 8][4] = {};

  const int k_end = causal ? min(S, q0 + MBM) : S;
  for (int k0 = 0; k0 < k_end; k0 += MBM) {
    __syncthreads();  // the previous tile is consumed
    load_tile<D>(Ks, k, b, k0, hkv, hkv_n, S);
    load_tile<D>(Vs, v, b, k0, hkv, hkv_n, S);
    __syncthreads();
    float s[NK][4] = {}, dp[NK][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      frag_a<L>(aq, Qs, warp * 16, kk * 16, g, t);
      frag_a<L>(ao, Os, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        uint32_t bk[2], bv[2];
        frag_b<L>(bk, Ks, j * 8, kk * 16, g, t);
        frag_b<L>(bv, Vs, j * 8, kk * 16, g, t);
        mma_bf16(s[j], aq, bk);     // s = q k^T
        mma_bf16(dp[j], ao, bv);    // dp = dO v^T
      }
    }
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        const int row = row_lo + hi * 8;
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const bool ok = row < S && key < S && (!causal || key <= row);
        const float p = ok ? expf(s[j][e] * scale - lse_r[hi]) : 0.f;
        dp[j][e] = p * (dp[j][e] - delta_r[hi]) * scale;  // ds
      }
    uint32_t ads[NK / 2][4];
    to_a<NK>(ads, dp);    // ds.astype(k.dtype)
#pragma unroll
    for (int jj = 0; jj < NK / 2; ++jj)
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bk[2];
        frag_bt<L>(bk, Ks, jj * 16, n * 8, g, t);
        mma_bf16(dqa[n], ads[jj], bk);   // dq += ds k
      }
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = row_lo + hi * 8;
    if (r >= S) continue;
    const size_t base = (((size_t)b * S + r) * H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dq + base + n * 8 + 2 * t) =
          pack_bf16(dqa[n][2 * hi], dqa[n][2 * hi + 1]);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dq, void* dk, void* dv, int B, int S, int H, int group,
               float scale, int causal, cudaStream_t st) {
  constexpr int TILE_BYTES = MBM * (D + 8) * sizeof(bf16);
  constexpr int DKDV_SMEM = 4 * TILE_BYTES + 2 * MBM * sizeof(float);
  constexpr int DQ_SMEM = 4 * TILE_BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_mma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, DKDV_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DQ_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (S + MBM - 1) / MBM;
  flash_bwd_dkdv_mma<D><<<dim3(tiles, B * (H / group)), MNT, DKDV_SMEM, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H,
      group, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_mma<D><<<dim3(tiles, B * H), MNT, DQ_SMEM, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), S, H, group, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, void* dk, void* dv, int B, int S, int H, int group,
           float scale, int causal, cudaStream_t st) {
  const int tiles = (S + ROWS - 1) / ROWS;
  flash_bwd_dkdv_kernel<T, D><<<dim3(tiles, B * (H / group)), NT, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), S, H,
      group, scale, causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T, D><<<dim3(tiles, B * H), NT, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), S, H, group, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout, dq: (B, S, H, D); k, v, dk, dv: (B, S, H / group, D);
// lse, delta: (B, H, S) fp32.  dtype: 0 = float32, 1 = bfloat16.
// Two launches (dk/dv, then dq) on `stream`; returns the first cudaError_t.
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dq, void* dk, void* dv,
                         int B, int S, int H, int group, int D, int dtype, int causal,
                         float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1 || group < 1 || H % group) return cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, group, scale, causal, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, group, scale, causal, st);
  if (dtype == 1 && D == 64)
    return launch_mma<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, group, scale, causal, st);
  if (dtype == 1 && D == 128)
    return launch_mma<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, group, scale, causal, st);
  return cudaErrorInvalidValue;
}
