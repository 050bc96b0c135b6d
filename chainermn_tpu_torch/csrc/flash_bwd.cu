// Flash-attention backward for Hopper (sm_90a), plain CUDA C++ behind a C ABI.
//
// Replaces: chainermn_tpu/ops/flash_attention.py :: _bwd_fused_kernel (the
// pallas_call in _bwd_pallas).  Same function: dq, dk, dv from q, k, v, dO,
// the forward's LSE and delta = rowsum(dO*O) - dlse, recomputing p = exp(s
// - lse) tile by tile so no (S, S) score matrix exists.  JAX's rounding is
// kept: p is rounded to dO's dtype before the dv product, ds = p*(dp -
// delta)*scale to q's dtype before dk and to k's dtype before dq; every sum
// is fp32.  GQA: dk and dv of one KV head are summed over its `group` q
// heads in fp32, never expanded.  The ragged tail past S is masked here
// instead of padded; causal cells above the diagonal are never visited.
//
// Bound on this card: at the training shape (B 8, S 1024, H 8, hd 128,
// bf16, causal) the function reads q, k, v, O, dO once and writes dq, dk,
// dv (~134 MB, 0.040 ms at 3.35 TB/s) and does five (S x S/2 x hd) products,
// 4.3e10 FLOP, 0.044 ms on the bf16 tensor cores: it is bound by
// operations.  The TPU kernel writes dq as per-K-block partials summed
// outside, because its grid is K-major; blocks on Hopper run in no order,
// so the work is three launches, each of which owns its output rows and
// needs neither atomics nor partials (deterministic):
//
//   delta: one pass over O and dO (16-byte loads, fp32 sums, a row per 8
//          or 16 lanes), minus dlse where given: (B, H, S) fp32.
//   dkdv:  one block per (b*h_kv, 128-key tile), heavy tiles first; it
//          walks the group's q heads and their 64-row q tiles from the
//          diagonal on, accumulating dk and dv in fp32 registers.
//   dq:    one block per (b*h, 128-row q tile), heavy tiles first; it walks
//          64-key tiles up to the diagonal, accumulating dq in fp32.  dq is
//          rounded once at the end (JAX rounds one partial per 2048-key
//          block, which is the same rounding for S <= 2048).
//
// bf16 (hd 64, 128): TMA + wgmma on the forward's plumbing.  Warpgroup 0 is
// the producer (setmaxnreg 40): one thread issues TMA loads of 64-row x
// 64-column boxes (128-byte swizzle) through 4-D maps over (D, heads, S,
// B); the block's own 128 rows (K and V, or Q and dO) are loaded once and
// the streamed operand goes through a ring of 64-row tiles (4 stages at hd
// 64, 3 at hd 128), each stage released by its consumers' arrivals.
// Warpgroups 1 and 2 (setmaxnreg 232) each own 64 of the block's rows.
// Per streamed tile, with every product a wgmma m64nNk16 in fp32:
//
//   dkdv (per 64-row q tile; the producer's first warp also stages the
//   tile's lse * log2(e) and delta in shared memory):
//     S^T = K Q^T and dP^T = V dO^T    (shared x shared, both K-major)
//     P^T = exp2(S^T scale log2e - lse log2e), masked; dS^T = P^T (dP^T -
//     delta) scale, both in registers
//     dV += bf16(P^T) dO, dK += bf16(dS^T) Q   (registers x shared, the
//     accumulator layout of 16 columns is the A fragment; dO and Q read
//     N-major from the same boxes)
//   dq (per 64-key tile; lse and delta of a thread's two rows in registers):
//     S = Q K^T and dP = dO V^T; P, dS; dQ += bf16(dS) K  (K N-major)
//
// A consumer skips the products of a tile that the causal mask empties for
// its 64 rows but still releases the stage.  Each bf16 packing of a
// fragment is JAX's rounding.  Outputs leave through a quad transpose as
// 16-byte stores of rows < S.  The function needs 5 products; 7 are done
// here (S and dP in both launches), the price of owning every output row
// without atomics.
//
// fp32 keeps the CUDA-core kernels (wgmma has no fp32 mode, and TF32 would
// change the function): 32 rows per block, eight threads per row holding
// an eighth of the row and of its accumulators in registers, dot products
// summed with three shuffles, the streamed operand staged in shared memory.

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O) - dlse
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

__device__ __forceinline__ void load16(const bf16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// o, dout: (B, S, H, D) rows; delta, dlse: (B, H, S).  LPR lanes a row.
template <typename T, int D>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ dlse,
    float* __restrict__ delta, int rows, int S, int H) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LPR = D / VEC;
  static_assert(LPR <= 32 && 32 % LPR == 0, "a row does not tile a warp");
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = gt / LPR, li = gt % LPR;
  float sum = 0.f;
  if (row < rows) {
    float a[VEC], g[VEC];
    load16(o + (size_t)row * D + li * VEC, a);
    load16(dout + (size_t)row * D + li * VEC, g);
#pragma unroll
    for (int e = 0; e < VEC; ++e) sum = fmaf(a[e], g[e], sum);
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < rows && li == 0) {
    const int h = row % H, bs = row / H, s = bs % S, b = bs / S;
    const size_t idx = ((size_t)b * H + h) * S + s;
    delta[idx] = dlse != nullptr ? sum - dlse[idx] : sum;
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int TPR = 8;          // threads per row
constexpr int ROWS = 32;        // rows owned by a block
constexpr int TILE = 32;        // rows of the streamed operand per shared tile
constexpr int NT = ROWS * TPR;  // threads per block

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

// Thread `sub` of a row owns head dims (c*TPR + sub)*4 + e for chunk c and
// e in [0, 4): the eight threads of a row read neighbouring float4s.
__device__ __forceinline__ int dim_of(int c, int sub, int e) { return (c * TPR + sub) * 4 + e; }

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int S,
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
      const int d = dim_of(c, sub, e);
      kr[c][e] = key_ok ? k[kv_base + d] : 0.f;
      vr[c][e] = key_ok ? v[kv_base + d] : 0.f;
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
          qv = q[off];
          dov = dout[off];
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
          const float4 qq = *reinterpret_cast<const float4*>(&qs[i][dim_of(c, sub, 0)]);
          const float4 dd = *reinterpret_cast<const float4*>(&dos[i][dim_of(c, sub, 0)]);
          sp += qq.x * kr[c][0] + qq.y * kr[c][1] + qq.z * kr[c][2] + qq.w * kr[c][3];
          dpp += dd.x * vr[c][0] + dd.y * vr[c][1] + dd.z * vr[c][2] + dd.w * vr[c][3];
        }
        sp = row_sum(sp);
        dpp = row_sum(dpp);
        const bool ok = key_ok && qi < S && (!causal || kj <= qi);
        const float p = ok ? expf(sp * scale - lse_s[i]) : 0.f;
        const float ds = p * (dpp - delta_s[i]) * scale;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const float4 qq = *reinterpret_cast<const float4*>(&qs[i][dim_of(c, sub, 0)]);
          const float4 dd = *reinterpret_cast<const float4*>(&dos[i][dim_of(c, sub, 0)]);
          dva[c][0] += p * dd.x;
          dva[c][1] += p * dd.y;
          dva[c][2] += p * dd.z;
          dva[c][3] += p * dd.w;
          dka[c][0] += ds * qq.x;
          dka[c][1] += ds * qq.y;
          dka[c][2] += ds * qq.z;
          dka[c][3] += ds * qq.w;
        }
      }
    }
  }

  if (key_ok) {
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = dim_of(c, sub, e);
        dk[kv_base + d] = dka[c][e];
        dv[kv_base + d] = dva[c][e];
      }
  }
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int S, int H, int group,
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
      const int d = dim_of(c, sub, e);
      qr[c][e] = row_ok ? q[q_base + d] : 0.f;
      dor[c][e] = row_ok ? dout[q_base + d] : 0.f;
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
        kv_k = k[off];
        kv_v = v[off];
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
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][dim_of(c, sub, 0)]);
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][dim_of(c, sub, 0)]);
        sp += qr[c][0] * kk.x + qr[c][1] * kk.y + qr[c][2] * kk.z + qr[c][3] * kk.w;
        dpp += dor[c][0] * vv.x + dor[c][1] * vv.y + dor[c][2] * vv.z + dor[c][3] * vv.w;
      }
      sp = row_sum(sp);
      dpp = row_sum(dpp);
      const bool ok = row_ok && kj < S && (!causal || kj <= qi);
      const float p = ok ? expf(sp * scale - lse_i) : 0.f;
      const float ds = p * (dpp - delta_i) * scale;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][dim_of(c, sub, 0)]);
        dqa[c][0] += ds * kk.x;
        dqa[c][1] += ds * kk.y;
        dqa[c][2] += ds * kk.z;
        dqa[c][3] += ds * kk.w;
      }
    }
  }

  if (row_ok) {
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[q_base + dim_of(c, sub, e)] = dqa[c][e];
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int BOX = 8192;  // one 64 x 64 bf16 box

template <int HD>
struct Bwd {
  static constexpr int P = HD / 64;               // 64-column panels
  static constexpr int T64 = P * BOX;             // 64 rows of one operand: [panel]
  static constexpr int T128 = 2 * T64;            // 128 rows: [panel][64-row box]
  static constexpr int STAGES = HD == 64 ? 4 : 3;
  static constexpr int STAGE = 2 * T64;           // two streamed operands
  static constexpr int STATS = 2 * 64 * 4;        // dkdv: lse * log2e, delta of 64 rows
  static constexpr int THREADS = 384;
  static constexpr int DKDV_SMEM =
      1024 + 2 * T128 + STAGES * (STAGE + STATS) + 8 * (1 + 2 * STAGES);
  static constexpr int DQ_SMEM = 1024 + 2 * T128 + STAGES * STAGE + 8 * (1 + 2 * STAGES);
};

// A 64 x 64 score tile of one consumer: S (or S^T) and dP (or dP^T) from
// shared x shared products, both operands K-major.  a0/a1: the consumer's
// 64 rows of the two resident operands ([panel][64-row box] with 2 boxes a
// panel: the consumer's box is c); b0/b1: the streamed tile's ([panel]).
template <int HD>
__device__ __forceinline__ void score_tiles(float (&s)[32], float (&dp)[32], uint32_t a0,
                                            uint32_t a1, uint32_t b0, uint32_t b1, int c) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t ao = ((kk / 4) * 2 + c) * BOX + (kk % 4) * 32, bo = (kk / 4) * BOX + (kk % 4) * 32;
    wgmma_ss<0, 0>(s, smem_desc(a0 + ao, 16, 1024), smem_desc(b0 + bo, 16, 1024), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t ao = ((kk / 4) * 2 + c) * BOX + (kk % 4) * 32, bo = (kk / 4) * BOX + (kk % 4) * 32;
    wgmma_ss<0, 0>(dp, smem_desc(a1 + ao, 16, 1024), smem_desc(b1 + bo, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
}

// acc (64 x HD) += A (64 x 64, registers) * B (64 rows of a streamed tile,
// N-major: the panels one box apart)
template <int HD>
__device__ __forceinline__ void acc_product(float (&acc)[HD / 2], const uint32_t (&a)[4][4],
                                            uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(acc, a[kk], smem_desc(b + kk * 2048, BOX, 1024));
}

// 64 x 64 fp32 accumulator tile -> the A fragments of a product over its
// 64 columns, rounded to bf16
__device__ __forceinline__ void to_frags(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// Rows row, row + 8 of a consumer's 64 x HD accumulator, rounded to bf16,
// into (.., ld) rows of `out` (16-byte stores after a quad transpose).
template <int HD>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[HD / 2], int row, int S,
                                           size_t row_stride_elems, size_t base) {
  const int quad = threadIdx.x & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) {
      uint32_t pk[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * i + jj;
        pk[jj] = pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      }
      quad_transpose(pk);  // columns 8 * (4i + quad) .. + 7
      if (r < S)
        *reinterpret_cast<uint4*>(out + base + (size_t)r * row_stride_elems + 8 * (4 * i + quad)) =
            make_uint4(pk[0], pk[1], pk[2], pk[3]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(Bwd<HD>::THREADS, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                                const __grid_constant__ CUtensorMap map_k,
                                const __grid_constant__ CUtensorMap map_v,
                                const __grid_constant__ CUtensorMap map_do,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
                                int group, float scale, int causal) {
  using C = Bwd<HD>;
  constexpr int P = C::P, ST = C::STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's alignment
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t ks = base, vs = ks + C::T128, ring = vs + C::T128;
  const uint32_t stats = ring + ST * C::STAGE;  // [stage][lse * log2e | delta][64]
  float* stats_g = reinterpret_cast<float*>(gbase + (stats - base));
  const uint32_t bars = stats + ST * C::STATS;  // kv, full[ST], empty[ST]
  const uint32_t kv_bar = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + ST + s); };

  const int Hkv = H / group;
  const int BHkv = gridDim.x / ((S + 127) / 128);
  const int bkv = blockIdx.x % BHkv, kt = blockIdx.x / BHkv;  // key tile 0 (heaviest) first
  const int b = bkv / Hkv, hkv = bkv % Hkv;
  const int k0 = kt * 128;
  const int n_qt = (S + 63) / 64;
  const int qt_begin = causal ? k0 / 64 : 0;  // no q row above the block's first key
  const int per_head = n_qt - qt_begin;
  const int total = group * per_head;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 32);   // the producer warp's lanes, one with the bytes
      mbar_init(empty(s), 8);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect_tx(kv_bar, 2 * C::T128);
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          tma_load(ks + (p * 2 + c) * BOX, &map_k, kv_bar, 64 * p, hkv, k0 + 64 * c, b);
          tma_load(vs + (p * 2 + c) * BOX, &map_v, kv_bar, 64 * p, hkv, k0 + 64 * c, b);
        }
    }
    for (int it = 0; it < total; ++it) {
      const int s = it % ST;
      const int h = hkv * group + it / per_head;
      const int i0 = (qt_begin + it % per_head) * 64;
      mbar_wait(empty(s), ((it / ST) & 1) ^ 1);  // the stage's last use is done
      float* st = stats_g + s * 128;
      const size_t row_stats = ((size_t)b * H + h) * S;
#pragma unroll
      for (int j = lane; j < 64; j += 32) {
        const int qi = i0 + j;
        st[j] = qi < S ? lse[row_stats + qi] * LOG2E : 0.f;
        st[64 + j] = qi < S ? delta[row_stats + qi] : 0.f;
      }
      if (lane == 0) {
        const uint32_t qt = ring + s * C::STAGE, dot = qt + C::T64;
        mbar_expect_tx(full(s), C::STAGE);  // lane 0's arrival
#pragma unroll
        for (int p = 0; p < P; ++p) {
          tma_load(qt + p * BOX, &map_q, full(s), 64 * p, h, i0, b);
          tma_load(dot + p * BOX, &map_do, full(s), 64 * p, h, i0, b);
        }
      } else {
        mbar_arrive(full(s));
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, quad = lane & 3;
  const int kc0 = k0 + 64 * c;                          // this consumer's keys
  const int key0 = kc0 + 16 * warp + (lane >> 2);       // rows key0, key0 + 8
  const float sl2 = scale * LOG2E;

  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;

  mbar_wait(kv_bar, 0);
  for (int it = 0; it < total; ++it) {
    const int s = it % ST;
    const int i0 = (qt_begin + it % per_head) * 64;
    const uint32_t qt = ring + s * C::STAGE, dot = qt + C::T64;
    mbar_wait(full(s), (it / ST) & 1);
    if (!(causal && i0 + 63 < kc0)) {  // else every q row of the tile is above these keys
      float st[32], dp[32];
      score_tiles<HD>(st, dp, ks, vs, qt, dot, c);  // S^T = K Q^T, dP^T = V dO^T
      const float* lse2 = stats_g + s * 128;
      const float* dl = lse2 + 64;
      const bool edge = (causal && i0 < kc0 + 64) || i0 + 64 > S || kc0 + 64 > S;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * quad + (e & 1);  // q row i0 + col
          float p = exp2f(st[4 * j + e] * sl2 - lse2[col]);
          if (edge) {
            const int qi = i0 + col, key = key0 + 8 * (e >> 1);
            if (qi >= S || key >= S || (causal && key > qi)) p = 0.f;
          }
          dp[4 * j + e] = p * (dp[4 * j + e] - dl[col]) * scale;  // dS^T
          st[4 * j + e] = p;                                       // P^T
        }
      uint32_t ap[4][4], as[4][4];
      to_frags(ap, st);  // p.astype(do.dtype)
      to_frags(as, dp);  // ds.astype(q.dtype)
      fence_regs(dka);
      fence_regs(dva);
      wgmma_fence();
      acc_product<HD>(dva, ap, dot);  // dV += P^T dO
      acc_product<HD>(dka, as, qt);   // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // Q, dO and the stats of this stage are consumed
  }

  const size_t ld = (size_t)Hkv * HD, off = ((size_t)b * S * Hkv + hkv) * HD;
  store_rows<HD>(dk, dka, key0, S, ld, off);
  store_rows<HD>(dv, dva, key0, S, ld, off);
}

template <int HD>
__global__ void __launch_bounds__(Bwd<HD>::THREADS, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dq, int S, int H, int group, float scale,
                              int causal) {
  using C = Bwd<HD>;
  constexpr int P = C::P, ST = C::STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base, dos = qs + C::T128, ring = dos + C::T128;
  const uint32_t bars = ring + ST * C::STAGE;  // q, full[ST], empty[ST]
  const uint32_t q_bar = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + ST + s); };

  const int n_qt = (S + 127) / 128;
  const int BH = gridDim.x / n_qt;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - blockIdx.x / BH) * 128;  // heavy first
  const int b = bh / H, h = bh % H, hkv = h / group;
  const int n_kv = (S + 63) / 64;
  const int n_kt = causal ? min(n_kv, (q0 + 127) / 64 + 1) : n_kv;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, 2 * C::T128);
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          tma_load(qs + (p * 2 + c) * BOX, &map_q, q_bar, 64 * p, h, q0 + 64 * c, b);
          tma_load(dos + (p * 2 + c) * BOX, &map_do, q_bar, 64 * p, h, q0 + 64 * c, b);
        }
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % ST;
        const uint32_t kt = ring + s * C::STAGE, vt = kt + C::T64;
        mbar_wait(empty(s), ((it / ST) & 1) ^ 1);
        mbar_expect_tx(full(s), C::STAGE);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          tma_load(kt + p * BOX, &map_k, full(s), 64 * p, hkv, it * 64, b);
          tma_load(vt + p * BOX, &map_v, full(s), 64 * p, hkv, it * 64, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, quad = lane & 3;
  const int qc0 = q0 + 64 * c;                       // this consumer's q rows
  const int row0 = qc0 + 16 * warp + (lane >> 2);    // rows row0, row0 + 8
  const float sl2 = scale * LOG2E;
  float lse2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    lse2[hh] = r < S ? lse[((size_t)b * H + h) * S + r] * LOG2E : 0.f;
    dl[hh] = r < S ? delta[((size_t)b * H + h) * S + r] : 0.f;
  }

  float dqa[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;

  mbar_wait(q_bar, 0);
  for (int it = 0; it < n_kt; ++it) {
    const int s = it % ST;
    const int j0 = it * 64;
    const uint32_t kt = ring + s * C::STAGE, vt = kt + C::T64;
    mbar_wait(full(s), (it / ST) & 1);
    if (!(causal && j0 > qc0 + 63)) {  // else every key of the tile is past these rows
      float st[32], dp[32];
      score_tiles<HD>(st, dp, qs, dos, kt, vt, c);  // S = Q K^T, dP = dO V^T
      const bool edge = (causal && j0 + 63 > qc0) || j0 + 64 > S || qc0 + 64 > S;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          float p = exp2f(st[4 * j + e] * sl2 - lse2[hh]);
          if (edge) {
            const int key = j0 + 8 * j + 2 * quad + (e & 1), row = row0 + 8 * hh;
            if (key >= S || row >= S || (causal && key > row)) p = 0.f;
          }
          dp[4 * j + e] = p * (dp[4 * j + e] - dl[hh]) * scale;  // dS
        }
      uint32_t as[4][4];
      to_frags(as, dp);  // ds.astype(k.dtype)
      fence_regs(dqa);
      wgmma_fence();
      acc_product<HD>(dqa, as, kt);  // dQ += dS K
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  store_rows<HD>(dq, dqa, row0, S, (size_t)H * HD, ((size_t)b * S * H + h) * HD);
}

template <typename T>
int launch_delta(const void* o, const void* dout, const void* dlse, void* delta, int B, int S,
                 int H, int D, cudaStream_t st) {
  const int rows = B * S * H;
  const int lpr = D / (16 / static_cast<int>(sizeof(T)));
  const int blocks = static_cast<int>(((long long)rows * lpr + 255) / 256);
  auto kern = D == 64 ? flash_bwd_delta_kernel<T, 64> : flash_bwd_delta_kernel<T, 128>;
  kern<<<blocks, 256, 0, st>>>(static_cast<const T*>(o), static_cast<const T*>(dout),
                               static_cast<const float*>(dlse), static_cast<float*>(delta), rows,
                               S, H);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dq, void* dk, void* dv, int B, int S, int H, int group,
               float scale, int causal, cudaStream_t st) {
  const int tiles = (S + ROWS - 1) / ROWS;
  flash_bwd_dkdv_f32_kernel<D><<<dim3(tiles, B * (H / group)), NT, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), S, H,
      group, scale, causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_f32_kernel<D><<<dim3(tiles, B * H), NT, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), S, H, group, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dq, void* dk, void* dv, int B, int S, int H, int group,
                float scale, int causal, cudaStream_t st) {
  using C = Bwd<HD>;
  const int hkv = H / group;
  CUtensorMap mq, mk, mv, mdo;
  int err;
  if ((err = make_map_4d(&mq, q, HD, H, S, B, 64, 1, 64, 1)) ||
      (err = make_map_4d(&mk, k, HD, hkv, S, B, 64, 1, 64, 1)) ||
      (err = make_map_4d(&mv, v, HD, hkv, S, B, 64, 1, 64, 1)) ||
      (err = make_map_4d(&mdo, dout, HD, H, S, B, 64, 1, 64, 1)))
    return err;
  if ((err = static_cast<int>(cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<HD>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   C::DKDV_SMEM))) ||
      (err = static_cast<int>(cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<HD>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   C::DQ_SMEM))))
    return err;
  const int tiles = (S + 127) / 128;
  flash_bwd_dkdv_wgmma_kernel<HD><<<tiles * B * hkv, C::THREADS, C::DKDV_SMEM, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, group, scale, causal);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  flash_bwd_dq_wgmma_kernel<HD><<<tiles * B * H, C::THREADS, C::DQ_SMEM, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), S, H, group, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out, dout, dq: (B, S, H, D); k, v, dk, dv: (B, S, H / group, D), all
// contiguous with 16-byte aligned bases; lse, delta and dlse (or null):
// (B, H, S) fp32; delta is written here.  dtype: 0 = float32, 1 = bfloat16.
// Three launches on `stream` (delta, dk/dv, dq); returns the first
// cudaError_t, or a negated CUresult of cuTensorMapEncodeTiled.
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* out,
                         const void* dout, const void* lse, const void* dlse, void* delta,
                         void* dq, void* dk, void* dv, int B, int S, int H, int group, int D,
                         int dtype, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1 || group < 1 || H % group || (D != 64 && D != 128) ||
      (dtype != 0 && dtype != 1) || (long long)B * H * S > (1LL << 31))
    return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) || !aligned16(dout) ||
      !aligned16(dq) || !aligned16(dk) || !aligned16(dv))
    return cudaErrorMisalignedAddress;
  int err = dtype == 0 ? launch_delta<float>(out, dout, dlse, delta, B, S, H, D, st)
                       : launch_delta<bf16>(out, dout, dlse, delta, B, S, H, D, st);
  if (err) return err;
  if (dtype == 0)
    return D == 64 ? launch_f32<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, group, scale,
                                    causal, st)
                   : launch_f32<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, group,
                                     scale, causal, st);
  return D == 64 ? launch_bf16<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, group, scale,
                                   causal, st)
                 : launch_bf16<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, group, scale,
                                    causal, st);
}
