// Flash-attention forward for Hopper (sm_90a), plain CUDA C++ behind a C ABI.
//
// Replaces: chainermn_tpu/ops/flash_attention.py :: _fwd_kernel (the
// pallas_call in _flash_fwd).  Same function: causal or full attention over
// (B, S, H, D), fp32 online softmax, O in the input dtype and the per-row
// log-sum-exp in fp32; GQA by letting `group` consecutive q heads read one
// KV head; the ragged tail past S masked here instead of padded.  JAX's
// masking is kept: s = (q.k in fp32) * scale, finite -1e30 sentinel where
// masked, p zeroed there, l summed from the unrounded fp32 p, p rounded to
// bf16 only for the PV product, o = acc / max(l, 1e-37) rounded once, lse =
// m + log(max(l, 1e-37)).
//
// Bound on this card: at the training shape (B 8, S 1024, H 8, hd 128,
// causal, bf16) the function moves q, k, v and o once, 67 MB, 20 us at 3.35
// TB/s; its 17.2 GFLOP take 17 us on the bf16 tensor cores: bytes bound it,
// barely.  At the prefill shape (B 8, S 512, H 16, hd 64) 10 us of bytes.
//
// bf16 design (TMA + wgmma).  One block per (tile of 128 q rows, b * h):
// warpgroup 0 is the producer, warpgroups 1 and 2 each own 64 q rows.
//   * TMA.  4-D tensor maps over q (D, H, S, B) and k / v (D, H_kv, S, B),
//     boxes of 64 columns x 64 rows (one 128-byte swizzle line a row, 8 KB);
//     hd 128 is two 64-column panels.  q is loaded once; K and V tiles of 128
//     keys go through a ring of 4 (hd 64) or 3 (hd 128) stages, each stage
//     released by its consumers' arrivals on an mbarrier.  TMA fills rows
//     past S with zeros; those keys are masked by index, not by value.
//   * S = Q K^T: wgmma m64n128k16, both operands K-major in shared memory
//     (SBO 1 KB, a k step of 32 bytes, the second panel 16 KB on), fp32
//     accumulators: 64 registers a thread.
//   * Softmax in registers.  A thread holds two rows (lane / 4, + 8) of 32
//     columns; the row max and the row sum go over the quad (shfl_xor 1, 2;
//     the sum only once, at the end: the quad shares alpha).  The
//     exponentials are exp2f with log2(e) folded into the scale (bf16 is
//     held at 2e-2; the fp32 kernel below keeps expf).  The mask is applied
//     only on a tile that holds the diagonal or the ragged tail.
//   * O += P V: p rounded to bf16 and packed in pairs straight from the S
//     accumulator into the A registers of wgmma m64n{64,128}k16 (register
//     form: the accumulator layout of 16 columns is the A fragment's); V is
//     N-major in shared memory (the transpose bit; 64-key boxes, the d panels
//     8 KB apart: LBO 8 KB, SBO 1 KB, a 16-key step 2 KB).
//   * Causal: a block walks key tiles up to its diagonal only, and the grid
//     runs the q tiles heavy-first (the longest rows start in the first
//     wave).  o leaves through a quad transpose as 16-byte stores of rows
//     < S; lse from one thread of the quad.
//   * A 64-row variant (one consumer) for grids under 132 blocks, such as
//     the serving prefill (B 1, S 512, H 16: 64 blocks of 128 rows), was
//     timed against this kernel at that shape in one session
//     (scripts/time_torch_flash.py, H100 SXM at 700 W): medians of 0.020 to
//     0.083 ms against 0.022 to 0.025, slower in five of six.  So there is
//     one bf16 kernel.
//   * ptxas (sm_90a, CUDA 12.9): 168 registers (the launch bound; setmaxnreg
//     gives consumers 232, the producer 40); no spill.
//
// fp32 keeps the first, CUDA-core kernel (wgmma has no fp32 mode, and TF32
// would change the function): one block per (b*h, 64-row q tile), four
// threads per q row, 32-key tiles of K and V staged in shared memory as
// fp32, causal tiles past the diagonal never loaded.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG = -1e30f;

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // query rows per block
constexpr int TPR = 4;        // threads per query row
constexpr int BK = 32;        // keys per shared-memory tile (one mask bit each)
constexpr int NT = BQ * TPR;  // threads per block

// Thread `sub` of a row owns head dims (c*TPR + sub)*4 + e for chunk c and
// e in [0, 4): the four threads of a row read neighbouring float4s.
template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int S, int H, int group, float scale,
    int causal) {
  constexpr int CH = D / (TPR * 4);  // float4 chunks per thread
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int sub = tid % TPR;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hkv_n = H / group;
  const int hkv = h / group;
  const int qi = q0 + r;
  const bool row_ok = qi < S;

  const size_t q_base = (((size_t)b * S + qi) * H + h) * D;
  float qr[CH][4];
  float acc[CH][4];
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = (c * TPR + sub) * 4 + e;
      qr[c][e] = row_ok ? q[q_base + d] : 0.f;
      acc[c][e] = 0.f;
    }
  float m = NEG;
  float l = 0.f;

  const int k_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < BK * D; idx += NT) {
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

    float s[BK];
    unsigned ok_bits = 0u;
    float tile_max = NEG;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][(c * TPR + sub) * 4]);
        part += qr[c][0] * kk.x + qr[c][1] * kk.y + qr[c][2] * kk.z + qr[c][3] * kk.w;
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kj = k0 + j;
      const bool ok = kj < S && (!causal || kj <= qi);
      ok_bits |= (ok ? 1u : 0u) << j;
      s[j] = ok ? part * scale : NEG;
      tile_max = fmaxf(tile_max, s[j]);
    }

    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= alpha;
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = ((ok_bits >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      p_sum += p;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][(c * TPR + sub) * 4]);
        acc[c][0] += p * vv.x;
        acc[c][1] += p * vv.y;
        acc[c][2] += p * vv.z;
        acc[c][3] += p * vv.w;
      }
    }
    l = l * alpha + p_sum;
    m = m_new;
  }

  if (row_ok) {
    const float lc = fmaxf(l, 1e-37f);
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[q_base + (c * TPR + sub) * 4 + e] = acc[c][e] / lc;
    if (sub == 0) lse[(size_t)bh * S + qi] = m + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma
// ---------------------------------------------------------------------------

constexpr int KT = 128;           // keys per tile
constexpr int BOX = 8192;         // one 64 x 64 bf16 box
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
struct Fwd {
  static constexpr int P = HD / 64;                // 64-column panels
  static constexpr int STAGES = HD == 64 ? 4 : 3;
  static constexpr int Q_BYTES = 2 * P * BOX;      // [panel][64-row box]
  static constexpr int KV_BYTES = 2 * P * BOX;     // one 128-key tile of K (or V)
  static constexpr int STAGE = 2 * KV_BYTES;       // K then V
  static constexpr int THREADS = 384;
  static constexpr int SMEM = Q_BYTES + STAGES * STAGE + 1024 + 8 * (1 + 2 * STAGES);
};

template <int HD>
__global__ void __launch_bounds__(Fwd<HD>::THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S, int H,
                           int group, float scale, int causal) {
  using C = Fwd<HD>;
  constexpr int P = C::P, S_ = C::STAGES;
  constexpr int RB = 128;  // q rows per block
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's alignment
  const uint32_t qs = base;
  const uint32_t ring = base + C::Q_BYTES;
  const uint32_t bars = ring + S_ * C::STAGE;  // q, full[S_], empty[S_]
  const uint32_t q_bar = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + S_ + s); };

  const int BH = gridDim.x / ((S + RB - 1) / RB);
  const int n_qt = (S + RB - 1) / RB;
  const int bh = blockIdx.x % BH;
  const int qt = n_qt - 1 - blockIdx.x / BH;  // heavy first
  const int q0 = qt * RB;
  const int b = bh / H, h = bh % H, hkv = h / group;
  const int n_kv = (S + KT - 1) / KT;
  const int n_kt = causal ? min(n_kv, (q0 + RB - 1) / KT + 1) : n_kv;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < S_; ++s) {
      mbar_init(full(s), 1);            // the producer's expect_tx, then the bytes
      mbar_init(empty(s), 8);           // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          tma_load(qs + (p * 2 + c) * BOX, &map_q, q_bar, 64 * p, h, q0 + 64 * c, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % S_;
        const uint32_t ks = ring + s * C::STAGE, vs = ks + C::KV_BYTES;
        mbar_wait(empty(s), ((kt / S_) & 1) ^ 1);  // the stage's last use is done
        mbar_expect_tx(full(s), C::STAGE);
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int kh = 0; kh < 2; ++kh) {
            // K: [panel][key half], a panel's 128 keys contiguous (K-major)
            tma_load(ks + (2 * p + kh) * BOX, &map_k, full(s), 64 * p, hkv, kt * KT + 64 * kh, b);
            // V: [key half][panel], the panels one box apart (LBO)
            tma_load(vs + (kh * P + p) * BOX, &map_v, full(s), 64 * p, hkv, kt * KT + 64 * kh, b);
          }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int row0 = q0 + 64 * c + 16 * warp + (lane >> 2);  // rows row0, row0 + 8
  const float sl2 = scale * LOG2E;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // m in log2 units; l this thread's columns

  mbar_wait(q_bar, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % S_;
    const uint32_t ks = ring + s * C::STAGE, vs = ks + C::KV_BYTES;
    mbar_wait(full(s), (kt / S_) & 1);

    // S = Q K^T
    float sc[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint64_t da =
          smem_desc(qs + ((kk / 4) * 2 + c) * BOX + (kk % 4) * 32, 16, 1024);
      const uint64_t db = smem_desc(ks + (kk / 4) * 2 * BOX + (kk % 4) * 32, 16, 1024);
      wgmma_ss<0, 0>(sc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // scale, mask, online softmax (log2 units)
    const int k0 = kt * KT;
    const bool edge = k0 + KT > S || (causal && k0 + KT - 1 > q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * sl2;
        if (edge) {
          const int col = k0 + 8 * j + 2 * quad + (e & 1), row = row0 + 8 * (e >> 1);
          if (col >= S || (causal && col > row)) x = NEG;
        }
        sc[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      alpha[hh] = exp2f(m[hh] - mx[hh]);
      m[hh] = mx[hh];
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pv = exp2f(sc[4 * j + e] - mx[e >> 1]);
        if (edge) {
          const int col = k0 + 8 * j + 2 * quad + (e & 1), row = row0 + 8 * (e >> 1);
          if (col >= S || (causal && col > row)) pv = 0.f;
        }
        ps[e >> 1] += pv;  // l from the unrounded p
        sc[4 * j + e] = pv;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + ps[hh];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e >> 1];

    // O += bf16(P) V, P from registers
    uint32_t a[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t db = smem_desc(vs + (kk / 4) * P * BOX + (kk % 4) * 2048, BOX, 1024);
      wgmma_rs<1>(acc, a[kk], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty(s));  // K and V of this stage are consumed
  }

  // o = acc / max(l, 1e-37), rounded once; lse = m + log(max(l, 1e-37))
  const int BHS = (b * H + h);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float lc = fmaxf(lt, 1e-37f);
    const int row = row0 + 8 * hh;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) {
      uint32_t pk[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * i + jj;
        pk[jj] = pack_bf16(acc[4 * j + 2 * hh] / lc, acc[4 * j + 2 * hh + 1] / lc);
      }
      quad_transpose(pk);  // columns 8 * (4i + quad) .. + 7
      if (row < S)
        *reinterpret_cast<uint4*>(o + (((size_t)b * S + row) * H + h) * HD + 8 * (4 * i + quad)) =
            make_uint4(pk[0], pk[1], pk[2], pk[3]);
    }
    if (quad == 0 && row < S) lse[(size_t)BHS * S + row] = m[hh] * LN2 + logf(lc);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, void* lse, int B, int S,
               int H, int group, float scale, int causal, cudaStream_t st) {
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_f32_kernel<D><<<grid, NT, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), S, H, group, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B, int S,
                int H, int group, float scale, int causal, cudaStream_t st) {
  using C = Fwd<HD>;
  CUtensorMap mq, mk, mv;
  int err;
  const int hkv = H / group;
  if ((err = make_map_4d(&mq, q, HD, H, S, B, 64, 1, 64, 1)) ||
      (err = make_map_4d(&mk, k, HD, hkv, S, B, 64, 1, 64, 1)) ||
      (err = make_map_4d(&mv, v, HD, hkv, S, B, 64, 1, 64, 1)))
    return err;
  if ((err = static_cast<int>(cudaFuncSetAttribute(flash_fwd_wgmma_kernel<HD>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   C::SMEM))))
    return err;
  const int n_qt = (S + 127) / 128;
  flash_fwd_wgmma_kernel<HD><<<n_qt * B * H, C::THREADS, C::SMEM, st>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S, H, group, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (B, S, H, D); k, v: (B, S, H / group, D); lse: (B, H, S) fp32.
// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (TMA + wgmma: q, k, v 16-byte
// aligned).  Returns a cudaError_t, or a negated CUresult of
// cuTensorMapEncodeTiled.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int B, int S, int H, int group, int D, int dtype, int causal,
                         float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1 || group < 1 || H % group) return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (D == 64) return launch_f32<64>(q, k, v, o, lse, B, S, H, group, scale, causal, st);
    if (D == 128) return launch_f32<128>(q, k, v, o, lse, B, S, H, group, scale, causal, st);
    return cudaErrorInvalidValue;
  }
  if (dtype != 1 || (long long)B * H * S > (1LL << 31))
    return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return cudaErrorMisalignedAddress;
  if (D == 64) return launch_bf16<64>(q, k, v, o, lse, B, S, H, group, scale, causal, st);
  if (D == 128) return launch_bf16<128>(q, k, v, o, lse, B, S, H, group, scale, causal, st);
  return cudaErrorInvalidValue;
}
