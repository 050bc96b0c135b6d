// Beam / grouped-query decode attention over one cache segment for Hopper
// (sm_90a), plain CUDA C++ behind a C ABI.
//
// Replaces: chainermn_tpu/ops/decode_attention.py :: _beam_kernel (the
// pallas_call in beam_attend_parts, which decode_attend_gqa also runs).
// Same function: R query rows per cache row b (the beams of one prompt, or
// the g query heads sharing a KV head) attend row b of a cache segment
// (B, S, H*hd); per row and head it returns the online softmax UNNORMALISED,
// acc (fp32, no rounding of p), the running max m and the sum l, so that
// two segments (shared prompt + generated slots) merge outside with the
// flash combine.  Mask modes: 0 none, 1 amask (B, R, S) int8/bool, valid
// where > 0, 2 pos (valid where t <= pos[b], or pos_scalar).  A masked
// score is the finite -1e30 sentinel, as in JAX, so a row with no valid
// position yields junk; callers guarantee one somewhere.
//
// Bound on this card: every K and V position of the segment is read once
// and serves all R rows: ~2 FLOP a byte against the card's ~295, so the
// launch is bound by bytes (the beam tick's generated window, 8 x 2048 x
// 1024 lanes of bf16 K and V, is 67 MB: 20 us at 3.35 TB/s).  The design
// puts bytes in flight and does each (r, t) once:
//
//   * Split S (flash-decoding).  The grid is (H, B, n_split); split z reads
//     positions [z * split_len, (z + 1) * split_len), split_len a multiple
//     of the 64-position tile (the wrapper's beam_split_plan: ~2 blocks an
//     SM, splits of 16 tiles or more where the grid is already half full).
//     In pos mode a split wholly past pos[b] exits at once and reads
//     nothing.
//   * A TMA ring of K and V tiles (64 positions x hd lanes) through a 3-D
//     map (lanes, positions, batch) that takes the batch stride, so a window
//     of a longer cache is read in place.  Positions past S arrive as zeros
//     and are excluded by index.
//   * Each score, and each p = exp(s - m), once per (r, t); each amask byte
//     read once, before the wait for its tile.  p is never rounded: the PV
//     sums run on CUDA cores in fp32.
//   * A second launch merges the splits' (acc, m, l) in split order
//     (deterministic): M = max m_i, acc = sum exp(m_i - M) acc_i, l alike.
//     An all-masked split carries m = -1e30 and weighs exp(-1e30 - M) = 0
//     beside a valid one, as a masked stretch does in one pass.  With one
//     split the first launch writes the outputs itself.
//
// bf16 (beam_split_mma_kernel): the scores on the tensor cores and one
// online softmax per warp over its quarter of every tile, no block barrier
// in the loop (see the kernel).  fp32 (beam_split_f32_kernel, for parity
// runs): eight threads a position reduce the dot products with shuffles,
// one warp per row takes the tile's max, and every thread owns a (row,
// chunk) accumulator over a subset of positions.

#include "hopper.cuh"

#include <stdint.h>

namespace {

using namespace hopper;

constexpr float NEG = -1e30f;
constexpr int TP = 64;  // positions per tile

// Eight bf16 values (16 bytes) as fp32.
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// positions [0, n) of row b are read: all of S, or up to pos in mode 2
__device__ __forceinline__ int valid_len(int mode, const int* pos, int pos_scalar, int b, int S) {
  if (mode != 2) return S;
  return min(pos != nullptr ? pos[b] : pos_scalar, S - 1) + 1;
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

template <int HD, int NR>
struct F32 {
  static constexpr int NC = HD / 4;             // 16-byte chunks (4 lanes) a row
  // PV: one thread per (row, chunk, position group); TG groups
  static constexpr int TG = NC * NR >= 256 ? 1 : 256 / (NC * NR);
  static constexpr int NT = NC * NR * TG;       // threads: 256, or 512
  static constexpr int NW = NT / 32;
  static constexpr int RPW = (NR + NW - 1) / NW;  // rows per warp in the softmax
  static constexpr int PP = NT / 8;             // positions per score pass
  static constexpr int PASSES = TP / PP;
  static constexpr int CPT = NC / 8;            // chunks per thread in a score pass
  static constexpr int RPS = (NR + 7) / 8;      // rows a score thread stores
  static constexpr int TILE = TP * HD * 4;      // K (or V) bytes
  static constexpr int STAGES = 2;
  static constexpr int RING = STAGES * 2 * TILE;
  static constexpr int Q_OFF = RING;                          // q: NR x HD
  static constexpr int S_OFF = Q_OFF + NR * HD * 4;           // s, then p: NR x TP
  static constexpr int C_OFF = S_OFF + NR * TP * 4;           // corr: NR
  static constexpr int RED_OFF = C_OFF + ((NR * 4 + 15) / 16) * 16;  // TG x NR x HD
  static constexpr int BAR_OFF = RED_OFF + (TG > 1 ? TG * NR * HD * 4 : 0);
  static constexpr int SMEM = BAR_OFF + 8 * STAGES + 128;     // + alignment slack
  static_assert(NC % 8 == 0 && TP % PP == 0 && NT <= 512, "shape does not tile the block");
};

// acc_o (n_split, B*R, H*hd), m_o / l_o (n_split, B*R, H): split z's
// unnormalised state (with one split, the outputs themselves).  Per tile:
// eight threads a position compute its R scores (16-byte reads of the K row
// and of q, in shared memory, one row per quarter-warp), one warp per row
// takes the tile's max and p, then each thread adds its positions' p v
// into the accumulators of one (row, chunk); three block barriers a tile.
template <int HD, int NR>
__global__ void __launch_bounds__(F32<HD, NR>::NT) beam_split_f32_kernel(
    const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
    const float* __restrict__ q, const int8_t* __restrict__ mask, const int* __restrict__ pos,
    float* __restrict__ acc_o, float* __restrict__ m_o, float* __restrict__ l_o, int pos_scalar,
    int mode, int S, int H, int R, int split_len, float scale) {
  using C = F32<HD, NR>;
  constexpr int NC = C::NC, TG = C::TG, NT = C::NT, PP = C::PP;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));
  const uint32_t ring = smem_u32(smem);
  float* q_s = reinterpret_cast<float*>(smem + C::Q_OFF);
  float* s_s = reinterpret_cast<float*>(smem + C::S_OFF);
  float* corr_s = reinterpret_cast<float*>(smem + C::C_OFF);
  float* red = reinterpret_cast<float*>(smem + C::RED_OFF);
  const uint32_t bars = ring + C::BAR_OFF;

  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int B = gridDim.y, D = H * HD;
  const int n = valid_len(mode, pos, pos_scalar, b, S);
  const int t_begin = split * split_len;
  if (t_begin >= n) return;  // past pos[b]: nothing to read; the merge skips it
  const int t_end = min(n, t_begin + split_len);
  const int n_tiles = (t_end - t_begin + TP - 1) / TP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  auto issue = [&](int i) {  // tile i of the split into its stage
    const int s = i % C::STAGES;
    const uint32_t dst = ring + s * 2 * C::TILE;
    mbar_expect_tx(bars + 8 * s, 2 * C::TILE);
    tma_load(dst, &map_k, bars + 8 * s, h * HD, t_begin + i * TP, b);
    tma_load(dst + C::TILE, &map_v, bars + 8 * s, h * HD, t_begin + i * TP, b);
  };
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) mbar_init(bars + 8 * s, 1);
    mbar_init_fence();
    for (int i = 0; i < min(C::STAGES, n_tiles); ++i) issue(i);
  }
  for (int i = tid; i < NR * HD; i += NT) {
    const int r = i / HD;
    q_s[i] = r < R ? q[(size_t)(b * R + r) * D + h * HD + i % HD] : 0.f;
  }
  __syncthreads();

  const int tpos = tid >> 3, sub = tid & 7;  // scores: position, chunks sub + 8 j
  // PV: chunk pc of row pr over positions pg, pg + TG, ...
  const int pc = tid % NC, pr = (tid / NC) % NR, pg = tid / (NC * NR);
  float m_run[C::RPW], l_run[C::RPW];
#pragma unroll
  for (int i = 0; i < C::RPW; ++i) {
    m_run[i] = NEG;
    l_run[i] = 0.f;
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % C::STAGES;
    const int t0 = t_begin + kt * TP;
    // this thread's amask bytes, read once per (r, t), before the wait
    int8_t mk[C::PASSES][C::RPS];
#pragma unroll
    for (int ps = 0; ps < C::PASSES; ++ps)
#pragma unroll
      for (int u = 0; u < C::RPS; ++u) {
        const int r = sub + 8 * u, t = t0 + tpos + PP * ps;
        mk[ps][u] = (mode == 1 && r < R && t < t_end) ? mask[((size_t)b * R + r) * S + t] : 1;
      }
    mbar_wait(bars + 8 * s, (kt / C::STAGES) & 1);
    const float* ks = reinterpret_cast<const float*>(smem + s * 2 * C::TILE);
    const float* vs = ks + TP * HD;

    // scores: s[r][t] = (q_r . k_t) * scale, masked; -1e30 past the split
#pragma unroll
    for (int ps = 0; ps < C::PASSES; ++ps) {
      const int tl = tpos + PP * ps;
      float part[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) part[r] = 0.f;
#pragma unroll
      for (int j = 0; j < C::CPT; ++j) {
        const int c = sub + 8 * j;
        const float4 k4 = *reinterpret_cast<const float4*>(ks + tl * HD + 4 * c);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const float4 x = *reinterpret_cast<const float4*>(q_s + r * HD + 4 * c);
          part[r] += x.x * k4.x + x.y * k4.y + x.z * k4.z + x.w * k4.w;
        }
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        part[r] += __shfl_xor_sync(0xffffffffu, part[r], 1);
        part[r] += __shfl_xor_sync(0xffffffffu, part[r], 2);
        part[r] += __shfl_xor_sync(0xffffffffu, part[r], 4);
      }
      const int t = t0 + tl;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if ((r & 7) != sub) continue;
        float x = part[r] * scale;
        if (t >= t_end || mk[ps][r / 8] <= 0) x = NEG;
        s_s[r * TP + tl] = x;
      }
    }
    __syncthreads();

    // one warp per row: the tile's max, p = exp(s - m_new), the rescale
#pragma unroll
    for (int i = 0; i < C::RPW; ++i) {
      const int r = warp + C::NW * i;
      if (r >= NR) break;
      const float x0 = s_s[r * TP + lane], x1 = s_s[r * TP + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      // positions past the split add nothing, not even where every score is -1e30
      const float p0 = t0 + lane < t_end ? expf(x0 - m_new) : 0.f;
      const float p1 = t0 + lane + 32 < t_end ? expf(x1 - m_new) : 0.f;
      s_s[r * TP + lane] = p0;
      s_s[r * TP + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * corr + sum;
      m_run[i] = m_new;
      if (lane == 0) corr_s[r] = corr;
    }
    __syncthreads();

    // acc[r][lanes] = acc * corr + sum_t p[r][t] v[t][lanes]
    const float corr = corr_s[pr];
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] *= corr;
#pragma unroll 4
    for (int tl = pg; tl < TP; tl += TG) {
      const float p = s_s[pr * TP + tl];
      const float4 v4 = *reinterpret_cast<const float4*>(vs + tl * HD + 4 * pc);
      acc[0] = fmaf(p, v4.x, acc[0]);
      acc[1] = fmaf(p, v4.y, acc[1]);
      acc[2] = fmaf(p, v4.z, acc[2]);
      acc[3] = fmaf(p, v4.w, acc[3]);
    }
    __syncthreads();  // the stage, s and corr are consumed
    if (tid == 0 && kt + C::STAGES < n_tiles) {
      fence_proxy_async();  // the generic reads of the stage before TMA rewrites it
      issue(kt + C::STAGES);
    }
  }

  const int B_R = B * R;
  const size_t row_base = (size_t)split * B_R + (size_t)b * R;
  const float4 acc4 = make_float4(acc[0], acc[1], acc[2], acc[3]);
  if (TG == 1) {
    if (pr < R)
      *reinterpret_cast<float4*>(acc_o + (row_base + pr) * D + h * HD + 4 * pc) = acc4;
  } else {
    // the position groups' partial sums, added in group order
    *reinterpret_cast<float4*>(red + (pg * NR + pr) * HD + 4 * pc) = acc4;
    __syncthreads();
    for (int i = tid; i < R * HD; i += NT) {
      const int r = i / HD, e = i % HD;
      float a = 0.f;
#pragma unroll
      for (int g = 0; g < TG; ++g) a += red[(g * NR + r) * HD + e];
      acc_o[(row_base + r) * D + h * HD + e] = a;
    }
  }
#pragma unroll
  for (int i = 0; i < C::RPW; ++i) {
    const int r = warp + C::NW * i;
    if (r < R && lane == 0) {
      m_o[(row_base + r) * H + h] = m_run[i];
      l_o[(row_base + r) * H + h] = l_run[i];
    }
  }
}

// The splits of lane d of row blockIdx.y merged in split order into (acc,
// m, l): one thread a lane, so that the split loads of many lanes overlap.
__global__ void __launch_bounds__(256) beam_merge_kernel(
    const float* __restrict__ acc_w, const float* __restrict__ m_w, const float* __restrict__ l_w,
    const int* __restrict__ pos, float* __restrict__ acc, float* __restrict__ m,
    float* __restrict__ l, int pos_scalar, int mode, int R, int S, int H, int hd, int split_len,
    int n_split) {
  const int row = blockIdx.y, B_R = gridDim.y, D = H * hd;
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  const int n = valid_len(mode, pos, pos_scalar, row / R, S);
  const int live = min(n_split, (n + split_len - 1) / split_len);  // splits that ran
  const int h = d / hd;
  float mx = m_w[(size_t)row * H + h];
#pragma unroll 4
  for (int i = 1; i < live; ++i) mx = fmaxf(mx, m_w[((size_t)i * B_R + row) * H + h]);
  float a = 0.f, lt = 0.f;
#pragma unroll 4
  for (int i = 0; i < live; ++i) {
    const size_t r = (size_t)i * B_R + row;
    const float w = expf(m_w[r * H + h] - mx);
    a += w * acc_w[r * D + d];
    lt += w * l_w[r * H + h];
  }
  acc[(size_t)row * D + d] = a;
  if (d % hd == 0) {
    m[(size_t)row * H + h] = mx;
    l[(size_t)row * H + h] = lt;
  }
}

// ---------------------------------------------------------------------------
// bf16: scores on the tensor cores, an online softmax per warp
// ---------------------------------------------------------------------------

constexpr int BOX = 8192;  // 64 lanes x 64 positions of bf16, 128-byte swizzle

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk cp (0..7) of position `row` in a panel of
// 64 lanes written by TMA with 128-byte swizzle (one position a 128-byte line).
__device__ __forceinline__ uint32_t swz(int row, int cp) {
  return row * 128 + ((cp ^ (row & 7)) << 4);
}

template <int HD, int NR>
struct Mma {
  static constexpr int P = HD / 64;              // 64-lane panels
  static constexpr int NRW = NR < 8 ? NR : 8;    // q rows a warp takes (one n8 tile)
  static constexpr int CW = 4 * ((NR + 7) / 8);  // consumers: position quarter x row group
  static constexpr int NT = 32 * (CW + 1);       // + the producer warp
  static constexpr int NC = HD / 8;              // 16-byte chunks of a row
  static constexpr int LPOS = 32 / NC;           // PV: lanes of one chunk, on other positions
  static constexpr int STAGE = 2 * P * BOX;      // K panels, then V panels
  static constexpr int STAGES = HD == 64 ? 3 : 2;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int PW = 16 * 8 + 8;          // floats: a warp's p (16 x 8), then corr (8)
  static constexpr int SMEM = 1024 + RING + CW * PW * 4 + 8 * 2 * STAGES;
  // four blocks an SM at the main paths' 4 rows (<= 102 registers); more
  // rows hold 64 accumulators a lane and take what they need
  static constexpr int MIN_BLOCKS = NR <= 4 ? 4 : 1;
  static_assert(CW * (NRW * HD + 16) * 4 <= RING, "the warps' states do not fit over the ring");
};

// The bf16 split.  Warp CW is the producer (one lane issues the TMA loads
// of K and V, 128-byte swizzled panels of 64 lanes x 64 positions); consumer
// warp w takes positions 16 (w % 4) .. + 15 of every tile for q rows
// 8 (w / 4) .. + 7 and keeps its own (m, l, acc) over them:
//   * S (16 positions x 8 rows) = K q^T on the tensor cores: ldmatrix of K
//     (the swizzle keeps it free of bank conflicts), q's B fragments in
//     registers; bf16 products are exact in fp32, so this is the function.
//   * scale, mask (the lane's 4 amask bytes, read a tile ahead), the rows'
//     max over the warp's 16 positions (3 shuffles), p = exp(s - m) once
//     per (r, t), l summed per lane and rescaled by corr.
//   * p and corr to the warp's 544 bytes of shared memory, then PV on CUDA
//     cores in fp32: lane (chunk c, position subset) converts each V chunk
//     it reads once and adds it into all rows' accumulators; a row whose
//     max did not move (corr == 1) is not rescaled.
// At the end the position subsets are summed over lanes, and the four
// warps of a row group merge in order through shared memory (over the
// ring) into the split's (acc, m, l).  No block barrier in the loop.
template <int HD, int NR>
__global__ void __launch_bounds__(Mma<HD, NR>::NT, Mma<HD, NR>::MIN_BLOCKS)
    beam_split_mma_kernel(const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ mask,
                          const int* __restrict__ pos, float* __restrict__ acc_o,
                          float* __restrict__ m_o, float* __restrict__ l_o, int pos_scalar,
                          int mode, int S, int H, int R, int split_len, float scale) {
  using C = Mma<HD, NR>;
  constexpr int P = C::P, NRW = C::NRW, ST = C::STAGES, NC = C::NC, LPOS = C::LPOS;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the swizzle's alignment
  uint8_t* gring = smem_raw + (ring - raw);
  float* pw_all = reinterpret_cast<float*>(gring + C::RING);
  const uint32_t bars = ring + C::RING + C::CW * C::PW * 4;  // full[ST], empty[ST]

  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int B = gridDim.y, D = H * HD;
  const int n = valid_len(mode, pos, pos_scalar, b, S);
  const int t_begin = split * split_len;
  if (t_begin >= n) return;  // past pos[b]: nothing to read; the merge skips it
  const int t_end = min(n, t_begin + split_len);
  const int n_tiles = (t_end - t_begin + TP - 1) / TP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pq = warp & 3, rg = warp >> 2;       // position quarter, row group
  const int g = lane >> 2, t4 = lane & 3;        // mma fragment coordinates
  const int c_pv = lane % NC, ps = lane / NC;    // PV: chunk, position subset

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (ST + s), C::CW);
    }
    mbar_init_fence();
  }
  __syncthreads();

  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};  // rows 2 t4, 2 t4 + 1 of the group
  float acc[NRW][8];
  if (warp == C::CW) {
    if (lane == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        mbar_wait(bars + 8 * (ST + s), ((i / ST) & 1) ^ 1);  // the stage's last use is done
        mbar_expect_tx(bars + 8 * s, C::STAGE);
        const uint32_t dst = ring + s * C::STAGE;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          tma_load(dst + p * BOX, &map_k, bars + 8 * s, h * HD + 64 * p, t_begin + i * TP, b);
          tma_load(dst + (P + p) * BOX, &map_v, bars + 8 * s, h * HD + 64 * p, t_begin + i * TP,
                   b);
        }
      }
    }
  } else {
    // q's B fragments: row 8 rg + g (zero past R), lanes 16 kk + 2 t4 (+1), + 8
    uint32_t qb[HD / 16][2];
    {
      const int r = 8 * rg + g;
      const uint32_t* qrow =
          reinterpret_cast<const uint32_t*>(q + (size_t)(b * R + min(r, R - 1)) * D + h * HD);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        qb[kk][0] = r < R ? qrow[8 * kk + t4] : 0u;
        qb[kk][1] = r < R ? qrow[8 * kk + 4 + t4] : 0u;
      }
    }
#pragma unroll
    for (int r = 0; r < NRW; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
    const int rows0 = 8 * rg + 2 * t4;  // the lane's score rows
    // the lane's amask bytes of a tile: positions g, g + 8 of the quarter x its 2 rows
    auto mask_bytes = [&](int8_t (&mk)[4], int t0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int t = t0 + 16 * pq + g + 8 * i, r = rows0 + j;
          mk[2 * i + j] =
              (mode == 1 && r < R && t < t_end) ? mask[((size_t)b * R + r) * S + t] : 1;
        }
    };
    int8_t mk[4], mk_next[4];
    mask_bytes(mk_next, t_begin);
    float* pw = pw_all + warp * C::PW;  // p[16][8], then corr[8]
    float* cw = pw + 128;

    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s = kt % ST;
      const int t0 = t_begin + kt * TP;
#pragma unroll
      for (int i = 0; i < 4; ++i) mk[i] = mk_next[i];
      if (kt + 1 < n_tiles) mask_bytes(mk_next, t0 + TP);
      mbar_wait(bars + 8 * s, (kt / ST) & 1);
      const uint32_t kb = ring + s * C::STAGE;
      const uint8_t* vb = gring + s * C::STAGE + P * BOX;

      // c[2 i + j]: position 16 pq + g + 8 i, row rows0 + j
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, kb + (kk / 4) * BOX + swz(16 * pq + (lane & 15), 2 * (kk % 4) + (lane >> 4)));
        mma_16816(c, a, qb[kk][0], qb[kk][1]);
      }
      float x[4], p[4], mx[2], corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int t = t0 + 16 * pq + g + 8 * i;
          float v = c[2 * i + j] * scale;
          if (t >= t_end || mk[2 * i + j] <= 0) v = NEG;
          x[2 * i + j] = v;
        }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mx[j] = fmaxf(x[j], x[2 + j]);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], off));
        const float m_new = fmaxf(m_run[j], mx[j]);
        corr[j] = __expf(m_run[j] - m_new);
        m_run[j] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)  // positions past the split add nothing
          p[2 * i + j] = t0 + 16 * pq + g + 8 * i < t_end ? __expf(x[2 * i + j] - m_run[j]) : 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) l_run[j] = l_run[j] * corr[j] + p[j] + p[2 + j];
      *reinterpret_cast<float2*>(pw + g * 8 + 2 * t4) = make_float2(p[0], p[1]);
      *reinterpret_cast<float2*>(pw + (g + 8) * 8 + 2 * t4) = make_float2(p[2], p[3]);
      if (g == 0) *reinterpret_cast<float2*>(cw + 2 * t4) = make_float2(corr[0], corr[1]);
      __syncwarp();

      // acc[r][chunk c_pv] = acc * corr + sum over the lane's positions of p v
#pragma unroll
      for (int r = 0; r < NRW; ++r) {
        const float cr = cw[r];
        if (cr != 1.f) {
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] *= cr;
        }
      }
#pragma unroll
      for (int j = 0; j < 16 / LPOS; ++j) {
        const int tw = ps + LPOS * j, row = 16 * pq + tw;
        float v[8];
        load16(reinterpret_cast<const __nv_bfloat16*>(vb + (c_pv / 8) * BOX + swz(row, c_pv % 8)),
               v);
        float pr[NRW];
#pragma unroll
        for (int r = 0; r < NRW; ++r) pr[r] = pw[tw * 8 + r];
#pragma unroll
        for (int r = 0; r < NRW; ++r)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(pr[r], v[e], acc[r][e]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (ST + s));  // K and V of this stage are consumed
    }
    // the position subsets' sums, then l over the lanes of the 16 positions
#pragma unroll
    for (int r = 0; r < NRW; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int off = NC; off < 32; off <<= 1)
          acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l_run[j] += __shfl_xor_sync(0xffffffffu, l_run[j], off);
  }
  __syncthreads();  // every stage consumed: the warps' states go over the ring

  float* st_acc = reinterpret_cast<float*>(gring);  // [CW][NRW][HD]
  float* st_ml = st_acc + C::CW * NRW * HD;         // [CW][m 8 | l 8]
  if (warp < C::CW) {
    if (lane < NC) {
#pragma unroll
      for (int r = 0; r < NRW; ++r)
#pragma unroll
        for (int e = 0; e < 8; e += 4)
          *reinterpret_cast<float4*>(st_acc + (warp * NRW + r) * HD + c_pv * 8 + e) =
              make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2], acc[r][e + 3]);
    }
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        st_ml[warp * 16 + 2 * t4 + j] = m_run[j];
        st_ml[warp * 16 + 8 + 2 * t4 + j] = l_run[j];
      }
    }
  }
  __syncthreads();
  // the four position quarters of each row, merged in order
  const size_t row_base = (size_t)split * B * R + (size_t)b * R;
  for (int i = threadIdx.x; i < R * HD; i += C::NT) {
    const int r = i / HD, e = i % HD, w0 = 4 * (r / 8), rl = r % 8;
    float mx = st_ml[w0 * 16 + rl];
#pragma unroll
    for (int k = 1; k < 4; ++k) mx = fmaxf(mx, st_ml[(w0 + k) * 16 + rl]);
    float a = 0.f, lt = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int w = w0 + k;
      const float wt = expf(st_ml[w * 16 + rl] - mx);
      a += wt * st_acc[(w * NRW + rl) * HD + e];
      lt += wt * st_ml[w * 16 + 8 + rl];
    }
    acc_o[(row_base + r) * D + h * HD + e] = a;
    if (e == 0) {
      m_o[(row_base + r) * H + h] = mx;
      l_o[(row_base + r) * H + h] = lt;
    }
  }
}

struct Args {
  const void *q, *kc, *vc;
  const int8_t* mask;
  const int* pos;
  float *acc, *m, *l, *ws;
  int pos_scalar, mode, B, S, H, R;
  long long kv_stride;
  int split_len, n_split;
  float scale;
  cudaStream_t st;
};

// The split launch into (acc_w, m_w, l_w): fp32 on CUDA cores.
template <int HD, int NR>
int launch_split_f32(const Args& a, float* acc_w, float* m_w, float* l_w) {
  using C = F32<HD, NR>;
  const cuuint64_t D = static_cast<cuuint64_t>(a.H) * HD;
  const cuuint64_t dims[3] = {D, static_cast<cuuint64_t>(a.S), static_cast<cuuint64_t>(a.B)};
  const cuuint64_t strides[2] = {D * 4, static_cast<cuuint64_t>(a.kv_stride) * 4};
  const cuuint32_t box[3] = {HD, TP, 1};
  CUtensorMap mk, mv;
  int err;
  if ((err = make_map(&mk, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, CU_TENSOR_MAP_SWIZZLE_NONE, a.kc, 3,
                      dims, strides, box)) ||
      (err = make_map(&mv, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, CU_TENSOR_MAP_SWIZZLE_NONE, a.vc, 3,
                      dims, strides, box)))
    return err;
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      beam_split_f32_kernel<HD, NR>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM));
  if (attr) return attr;
  beam_split_f32_kernel<HD, NR><<<dim3(a.H, a.B, a.n_split), C::NT, C::SMEM, a.st>>>(
      mk, mv, static_cast<const float*>(a.q), a.mask, a.pos, acc_w, m_w, l_w, a.pos_scalar,
      a.mode, a.S, a.H, a.R, a.split_len, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// The split launch into (acc_w, m_w, l_w): bf16 with tensor-core scores.
template <int HD, int NR>
int launch_split_bf16(const Args& a, float* acc_w, float* m_w, float* l_w) {
  using C = Mma<HD, NR>;
  const cuuint64_t D = static_cast<cuuint64_t>(a.H) * HD;
  const cuuint64_t dims[3] = {D, static_cast<cuuint64_t>(a.S), static_cast<cuuint64_t>(a.B)};
  const cuuint64_t strides[2] = {D * 2, static_cast<cuuint64_t>(a.kv_stride) * 2};
  const cuuint32_t box[3] = {64, TP, 1};
  CUtensorMap mk, mv;
  int err;
  if ((err = make_map(&mk, a.kc, 3, dims, strides, box)) ||
      (err = make_map(&mv, a.vc, 3, dims, strides, box)))
    return err;
  // once a process: the decode paths call this launch every layer of every step
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      beam_split_mma_kernel<HD, NR>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM));
  if (attr) return attr;
  beam_split_mma_kernel<HD, NR><<<dim3(a.H, a.B, a.n_split), C::NT, C::SMEM, a.st>>>(
      mk, mv, static_cast<const __nv_bfloat16*>(a.q), a.mask, a.pos, acc_w, m_w, l_w,
      a.pos_scalar, a.mode, a.S, a.H, a.R, a.split_len, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16, int HD, int NR>
int launch(const Args& a) {
  const int D = a.H * HD;
  const size_t B_R = static_cast<size_t>(a.B) * a.R;
  float* acc_w = a.n_split > 1 ? a.ws : a.acc;
  float* m_w = a.n_split > 1 ? a.ws + a.n_split * B_R * D : a.m;
  float* l_w = a.n_split > 1 ? m_w + a.n_split * B_R * a.H : a.l;
  int err = BF16 ? launch_split_bf16<HD, NR>(a, acc_w, m_w, l_w)
                : launch_split_f32<HD, NR>(a, acc_w, m_w, l_w);
  if (err || a.n_split == 1) return err;
  beam_merge_kernel<<<dim3((D + 255) / 256, static_cast<unsigned>(B_R)), 256, 0, a.st>>>(
      acc_w, m_w, l_w, a.pos, a.acc, a.m, a.l, a.pos_scalar, a.mode, a.R, a.S, a.H, HD,
      a.split_len, a.n_split);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16, int HD>
int launch_rows(const Args& a) {
  if (a.R <= 1) return launch<BF16, HD, 1>(a);
  if (a.R <= 2) return launch<BF16, HD, 2>(a);
  if (a.R <= 4) return launch<BF16, HD, 4>(a);
  if (a.R <= 8) return launch<BF16, HD, 8>(a);
  if (a.R <= 16) return launch<BF16, HD, 16>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q: (B*R, H*hd); kc, vc: (B, S, H*hd) with rows dense and batch stride
// kv_stride (elements; bases 16-byte aligned, kv_stride a multiple of 16
// bytes: TMA reads them); mask: (B, R, S) int8/bool for mode 1, else unused;
// pos: (B,) int32 on the device for mode 2, or null to use pos_scalar.
// split_len (a multiple of 64) positions per split, n_split = ceil(S /
// split_len) splits; ws: fp32 (n_split, B*R, H*hd + 2H) when n_split > 1.
// Outputs acc (B*R, H*hd), m and l (B*R, H), fp32.  dtype: 0 = float32,
// 1 = bfloat16.  Returns a cudaError_t, or a negated CUresult of
// cuTensorMapEncodeTiled.
extern "C" int beam_attend(const void* q, const void* kc, const void* vc, const void* mask,
                           const void* pos, void* acc, void* m, void* l, void* ws,
                           int pos_scalar, int mode, int B, int S, int H, int R, int hd,
                           int dtype, long long kv_stride, int split_len, int n_split,
                           float scale, void* stream) {
  Args a{q, kc, vc, static_cast<const int8_t*>(mask), static_cast<const int*>(pos),
         static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
         static_cast<float*>(ws), pos_scalar, mode, B, S, H, R, kv_stride, split_len, n_split,
         scale, static_cast<cudaStream_t>(stream)};
  if (B < 1 || S < 1 || H < 1 || R < 1 || mode < 0 || mode > 2) return cudaErrorInvalidValue;
  if (mode == 1 && mask == nullptr) return cudaErrorInvalidValue;
  if (split_len < 1 || split_len % TP || n_split != (S + split_len - 1) / split_len ||
      (n_split > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  const long long esz = dtype == 0 ? 4 : 2;
  if (!aligned16(q) || !aligned16(kc) || !aligned16(vc) || (kv_stride * esz) % 16)
    return cudaErrorMisalignedAddress;
  if (dtype == 0 && hd == 64) return launch_rows<false, 64>(a);
  if (dtype == 0 && hd == 128) return launch_rows<false, 128>(a);
  if (dtype == 1 && hd == 64) return launch_rows<true, 64>(a);
  if (dtype == 1 && hd == 128) return launch_rows<true, 128>(a);
  return cudaErrorInvalidValue;
}
