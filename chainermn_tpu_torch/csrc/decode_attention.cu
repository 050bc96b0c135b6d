// One decode tick's attention for Hopper (sm_90a), with the tick's K/V append
// folded in; plain CUDA C++ behind a C ABI.
//
// Replaces: chainermn_tpu/ops/decode_attention.py :: _kernel (the
// pallas_call in decode_attend) and, on the tick, chainermn_tpu/ops/
// kv_cache.py :: _append_kernel (the pallas_call in cache_append), which
// JAX's tick runs first.  Same function: one query row per batch row against
// the flat cache (B, S, H*hd), positions past pos masked, all math in fp32
// with no rounding of p, the output in q's dtype.  pos is per row (the
// serving tick) or one value (the closed batch); the row attends [0, n_b),
// n_b = min(pos[b], S - 1) + 1.  With k_new / v_new given, the new row sits
// at n_b - 1 (the append's clamped start): the kernel attends it with k_new
// and v_new in the cache's dtype and stores them there, so the cache after
// the call equals cache_append's result and the output equals decode_attend
// on it.
//
// Bound on this card: the tick reads each row's K and V up to pos once
// (8 slots x ~550 positions x 2 KB x 2 in bf16 is 17.8 MB, 5.3 us at 3.35
// TB/s) against ~2 FLOP a byte, so it is bound by bytes; the append adds
// 32 KB and, as a launch of its own, a launch's latency.
//
// bf16 (decode_split_kernel):
//   * Split S on the device.  The grid is (n_split, B, groups); the host
//     picks n_split from B, the groups and the SM count only (no host sync
//     on pos): one wave of blocks, 16 a row at 8 slots.  Block (z, b, g)
//     reads n_b itself and takes tiles [z nt / k, (z + 1) nt / k) of the nt
//     tiles of [0, n_b): every live row is spread over all its blocks,
//     however long it is.  Tiles are `tile` positions (16 KB of K).
//   * Head groups.  A block takes the lanes of one group of H / groups
//     heads, at most 2048 lanes (a thread a 16-byte chunk), so one
//     instantiation takes any width; up to D 2048 there is one group.
//   * Whole cache rows.  With one group, positions [t0, t1) of row b are one
//     contiguous run of (t1 - t0) * D * 2 bytes, so a tile of K and one of V
//     are two 1-D bulk copies into a 3-stage ring (32 KB a stage), issued
//     together: the V read never waits for a score.  With several groups a
//     tile is one copy a position of the group's lanes.
//   * Scores: a thread owns 32 lanes of one position (its q lanes in
//     registers, four FMA chains) and reads them from shared memory with a
//     rotated chunk order (rows 2 KB apart sit on one bank); the hd / 32
//     threads of a head add with 1-2 shuffles.  Softmax and PV: a thread
//     owns 8 lanes (one 16-byte chunk) and a subset of the tile's
//     positions, takes its head's tile max over the scores in shared
//     memory, p = exp(s - m) unrounded and fp32 FMAs on CUDA cores.  Three
//     block barriers a tile.
//   * Merge in the launch.  Each block writes its (acc, m, l) to a
//     workspace, fences once and counts itself on its (row, group) counter;
//     the last block of the row's group merges the n_split partials in
//     split order, 16 a round with a running max (one round trip of loads a
//     round; the result does not depend on the arrival order): M = max m_i,
//     acc = sum exp(m_i - M) acc_i, l alike; it writes acc / l and resets
//     the counter to 0.  A block with no tile writes m = -1e30, l = 0, acc =
//     0, which weighs 0.
//   * The append: the block whose range holds n_b - 1 overwrites that row of
//     its stage with its group's lanes of k_new / v_new once the stage has
//     landed, and stores them into the caches; no other block of the launch
//     reads those lanes of that row.
//
// fp32 (decode_attend_kernel, for parity runs): one block of 8 warps per
// (b, head) on CUDA cores; with k_new given, the block first writes its
// head's lanes of the new row into the caches.

#include "hopper.cuh"

#include <stdint.h>

namespace {

using namespace hopper;

constexpr float NEG = -1e30f;

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

// Eight bf16 values (16 bytes) as fp32.
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// positions [0, n) of row b are attended; the new row, if any, is n - 1
__device__ __forceinline__ int valid_len(const int* pos, int pos_scalar, int b, int S) {
  const int p = pos != nullptr ? pos[b] : pos_scalar;
  return min(max(p, 0), S - 1) + 1;
}

// ---------------------------------------------------------------------------
// fp32: one block per (b, head)
// ---------------------------------------------------------------------------

constexpr int NW = 8;  // warps per block

template <int HD>
__global__ void __launch_bounds__(NW * 32) decode_attend_kernel(
    const float* __restrict__ q, long long q_rs, long long q_hs, const float* __restrict__ kn,
    long long kn_rs, long long kn_hs, const float* __restrict__ vn, long long vn_rs,
    long long vn_hs, float* kc, float* vc, float* __restrict__ o, const int* __restrict__ pos,
    int pos_scalar, int S, int H, float scale) {
  constexpr int VEC = 4;               // elements per 16-byte load
  constexpr int LPP = HD / VEC;        // lanes reading one position
  constexpr int PPW = 32 / LPP;        // positions per warp step
  constexpr int NG = NW * PPW;         // position groups per block
  static_assert(LPP <= 32 && 32 % LPP == 0, "head_dim does not tile a warp");

  __shared__ float m_s[NG];
  __shared__ float l_s[NG];
  __shared__ float acc_s[NG][HD];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g_in = lane / LPP;
  const int li = lane % LPP;
  const int grp = warp * PPW + g_in;
  const int D = H * HD;
  const int n = valid_len(pos, pos_scalar, b, S);

  if (kn != nullptr) {  // this head's lanes of the new row, before any read of it
    const size_t dst = ((size_t)b * S + n - 1) * D + h * HD;
    for (int e = threadIdx.x; e < HD; e += NW * 32) {
      kc[dst + e] = kn[b * kn_rs + h * kn_hs + e];
      vc[dst + e] = vn[b * vn_rs + h * vn_hs + e];
    }
    __syncthreads();
  }

  float qv[VEC];
  load16(q + b * q_rs + h * q_hs + li * VEC, qv);
  const size_t row0 = (size_t)b * S * D + h * HD + li * VEC;

  float m = NEG, l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  // every lane of a warp runs the same trip count, so the shuffles below
  // always see the whole warp
  for (int t0 = warp * PPW; t0 < n; t0 += NG) {
    const int t = t0 + g_in;
    const bool valid = t < n;
    float kv[VEC];
    float part = 0.f;
    if (valid) {
      load16(kc + row0 + (size_t)t * D, kv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) part += qv[e] * kv[e];
    }
#pragma unroll
    for (int off = LPP / 2; off > 0; off /= 2)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (valid) {
      const float s = part * scale;
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);
      const float pe = expf(s - m_new);
      float vv[VEC];
      load16(vc + row0 + (size_t)t * D, vv);
      l = l * corr + pe;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = acc[e] * corr + pe * vv[e];
      m = m_new;
    }
  }

#pragma unroll
  for (int e = 0; e < VEC; ++e) acc_s[grp][li * VEC + e] = acc[e];
  if (li == 0) {
    m_s[grp] = m;
    l_s[grp] = l;
  }
  __syncthreads();

  for (int d = threadIdx.x; d < HD; d += NW * 32) {
    float mx = NEG;
    for (int g = 0; g < NG; ++g) mx = fmaxf(mx, m_s[g]);
    float lt = 0.f, a = 0.f;
    for (int g = 0; g < NG; ++g) {
      const float w = expf(m_s[g] - mx);
      lt += l_s[g] * w;
      a += acc_s[g][d] * w;
    }
    o[(size_t)b * D + h * HD + d] = a / lt;
  }
}

// ---------------------------------------------------------------------------
// bf16: S split on the device, whole rows through a bulk-copy ring, the
// splits merged by the last block of each row
// ---------------------------------------------------------------------------

constexpr int NT = 256;                // threads of a block
constexpr int MAX_GW = 2048;           // lanes of a head group: a thread a 16-byte chunk
constexpr int ST = 3;                  // ring stages: 96 KB in flight at 32 KB a stage
constexpr int MAX_SMEM = 3 * 32768 + 1024;  // the largest ring + scores the host asks for
constexpr int MC = 16;                 // splits merged a round

template <int HD>
__global__ void __launch_bounds__(NT, 1) decode_split_kernel(
    const __nv_bfloat16* __restrict__ q, long long q_rs, long long q_hs,
    const __nv_bfloat16* __restrict__ kn, long long kn_rs, long long kn_hs,
    const __nv_bfloat16* __restrict__ vn, long long vn_rs, long long vn_hs, __nv_bfloat16* kc,
    __nv_bfloat16* vc, __nv_bfloat16* __restrict__ o, const int* __restrict__ pos,
    int pos_scalar, float* ws, int* counters, int S, int H, int tile, float scale) {
  constexpr int GU = HD / 32;  // 32-lane score units of a head
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int last;

  const int z = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  const int k = gridDim.x, B = gridDim.y, G = gridDim.z;
  const int D = H * HD, HG = H / G, GW = HG * HD;  // lanes of a row; heads, lanes of the group
  const int RB = GW * 2, RG = D * 2;      // bytes of the group's lanes of a row; of a cache row
  const int UPP = GW / 32, CH = GW / 8;   // score units, 16-byte chunks of the group's lanes
  const int PPB = NT / UPP, PS = NT / CH;  // positions a score pass, PV position subsets
  const int tid = threadIdx.x, lane = tid & 31;
  const uint32_t half = static_cast<uint32_t>(tile) * RB;  // K (or V) bytes of a stage
  uint8_t* ring = smem;
  float* s_s = reinterpret_cast<float*>(smem + ST * 2 * half);  // [tile][HG] scores
  const uint32_t bars = smem_u32(smem + ST * 2 * half + ((tile * HG * 4 + 15) & ~15));

  const int nb = valid_len(pos, pos_scalar, b, S);
  const int nt = (nb + tile - 1) / tile;
  const int lo = static_cast<int>(static_cast<long long>(z) * nt / k) * tile;
  const int hi = min(nb, static_cast<int>(static_cast<long long>(z + 1) * nt / k) * tile);
  const int n_tiles = hi > lo ? (hi - lo + tile - 1) / tile : 0;
  const int t_new = kn != nullptr ? nb - 1 : -1;
  const size_t base = (static_cast<size_t>(b) * S * D + g * GW) * 2;  // the group's lanes of row 0
  const uint8_t* krow = reinterpret_cast<const uint8_t*>(kc) + base;
  const uint8_t* vrow = reinterpret_cast<const uint8_t*>(vc) + base;

  auto issue = [&](int i) {  // tile i of the range into its stage: K and V together
    const int s = i % ST, t0 = lo + i * tile, tn = min(tile, hi - t0);
    const uint32_t dst = smem_u32(ring + s * 2 * half), bar = bars + 8 * s;
    mbar_expect_tx(bar, 2u * tn * RB);
    if (G == 1) {  // whole rows: one run of the cache
      bulk_load(dst, krow + (size_t)t0 * RG, tn * RB, bar);
      bulk_load(dst + half, vrow + (size_t)t0 * RG, tn * RB, bar);
    } else {  // the group's lanes: a run a position
      for (int p = 0; p < tn; ++p) {
        bulk_load(dst + p * RB, krow + (size_t)(t0 + p) * RG, RB, bar);
        bulk_load(dst + half + p * RB, vrow + (size_t)(t0 + p) * RG, RB, bar);
      }
    }
  };
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) mbar_init(bars + 8 * s, 1);
    mbar_init_fence();
    for (int i = 0; i < min(ST, n_tiles); ++i) issue(i);
  }

  // scores: lanes 32 su .. 32 su + 31 of positions sp, sp + PPB, ...; the
  // chunk order is rotated by (lane / 2) % 4 so that the 8 lanes of a
  // shared-memory phase hit 8 different bank groups
  const int su = tid % UPP, sp = tid / UPP;
  const bool s_on = sp < PPB;
  const int rot = (lane >> 1) & 3;
  float qr[4][8];  // q lanes of chunk (c + rot) % 4 of the unit, as fp32
  {
    const int lane0 = su * 32;
    const __nv_bfloat16* qp = q + b * q_rs + (g * HG + lane0 / HD) * q_hs + lane0 % HD;
#pragma unroll
    for (int c = 0; c < 4; ++c) load16(qp + 8 * ((c + rot) & 3), qr[c]);
  }
  // PV: lanes 8 pc .. 8 pc + 7 (head hp of the group) over positions pss, pss + PS, ...
  const int pc = tid % CH, pss = tid / CH, hp = pc * 8 / HD;
  const bool v_on = pss < PS;
  float m_run = NEG, l_run = 0.f, acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  __syncthreads();  // the barriers are initialised

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % ST, t0 = lo + i * tile, tn = min(tile, hi - t0);
    uint8_t* kt = ring + s * 2 * half;
    uint8_t* vt = kt + half;
    mbar_wait(bars + 8 * s, (i / ST) & 1);
    if (t_new >= t0 && t_new < t0 + tn) {
      // the append: the new row replaces the stale one in the stage and in
      // the caches (the copy of this row has landed: no race with it)
      const size_t r = t_new - t0;
      for (int c = tid; c < 2 * CH; c += NT) {
        const bool is_v = c >= CH;
        const int e = 8 * (is_v ? c - CH : c), head = g * HG + e / HD;
        const uint4 x = *reinterpret_cast<const uint4*>(
            is_v ? vn + b * vn_rs + head * vn_hs + e % HD : kn + b * kn_rs + head * kn_hs + e % HD);
        *reinterpret_cast<uint4*>((is_v ? vt : kt) + r * RB + 2 * e) = x;
        *reinterpret_cast<uint4*>((is_v ? vc : kc) + ((size_t)b * S + t_new) * D + g * GW + e) = x;
      }
      __syncthreads();
    }

    for (int j = 0; j < (tile + PPB - 1) / PPB; ++j) {  // the same trip count in every lane
      const int lp = sp + PPB * j;
      const bool on = s_on && lp < tn;
      float part = 0.f;
      if (on) {
        const uint8_t* kr = kt + (size_t)lp * RB + su * 64;
        float pc[4] = {0.f, 0.f, 0.f, 0.f};  // four chains of FMAs, not one
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float kv[8];
          load16(reinterpret_cast<const __nv_bfloat16*>(kr + 16 * ((c + rot) & 3)), kv);
#pragma unroll
          for (int e = 0; e < 8; ++e) pc[c] = fmaf(qr[c][e], kv[e], pc[c]);
        }
        part = (pc[0] + pc[1]) + (pc[2] + pc[3]);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (GU == 4) part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (on && su % GU == 0) s_s[lp * HG + su / GU] = part * scale;
    }
    __syncthreads();

    if (v_on) {
      float mt = NEG;
      for (int lp = 0; lp < tn; ++lp) mt = fmaxf(mt, s_s[lp * HG + hp]);
      const float m_new = fmaxf(m_run, mt);
      const float corr = __expf(m_run - m_new);
      l_run *= corr;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] *= corr;
#pragma unroll 4
      for (int lp = pss; lp < tn; lp += PS) {
        const float p = __expf(s_s[lp * HG + hp] - m_new);
        float vv[8];
        load16(reinterpret_cast<const __nv_bfloat16*>(vt + (size_t)lp * RB + pc * 16), vv);
        l_run += p;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(p, vv[e], acc[e]);
      }
      m_run = m_new;
    }
    __syncthreads();  // the stage and the scores are consumed
    if (tid == 0 && i + ST < n_tiles) {
      fence_proxy_async();  // the generic reads and writes of the stage before the copy
      issue(i + ST);
    }
  }

  // the position subsets' sums, over the ring (every stage is consumed)
  float* red = reinterpret_cast<float*>(ring);  // [PS][GW] acc, [PS][HG] l, [HG] m
  float* red_l = red + PS * GW;
  float* red_m = red_l + PS * HG;
  if (v_on) {
    float* r = red + pss * GW + pc * 8;
    *reinterpret_cast<float4*>(r) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(r + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
    if (pc % (HD / 8) == 0) {
      red_l[pss * HG + hp] = l_run;
      if (pss == 0) red_m[hp] = m_run;
    }
  }
  __syncthreads();
  const size_t BK = static_cast<size_t>(B) * k;
  float* w_acc = ws;             // [B][k][D]
  float* w_m = ws + BK * D;      // [B][k][H]
  float* w_l = w_m + BK * H;     // [B][k][H]
  const size_t part_row = static_cast<size_t>(b) * k + z;
  for (int d4 = tid; d4 < GW / 4; d4 += NT) {
    float4 a = reinterpret_cast<const float4*>(red)[d4];
    for (int p = 1; p < PS; ++p) {
      const float4 x = reinterpret_cast<const float4*>(red + p * GW)[d4];
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    }
    reinterpret_cast<float4*>(w_acc + part_row * D + g * GW)[d4] = a;
  }
  for (int h = tid; h < HG; h += NT) {
    float l = red_l[h];
    for (int p = 1; p < PS; ++p) l += red_l[p * HG + h];
    w_m[part_row * H + g * HG + h] = red_m[h];
    w_l[part_row * H + g * HG + h] = l;
  }

  // the last block of the row's group to arrive merges its partials: one
  // fence for the block (the barrier orders its threads' stores before it)
  int* counter = counters + b * G + g;
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(counter, 1) == k - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  // a thread a float4 of lanes: MC splits' acc, m and l loaded together
  // through L2 (__ldcg: not through this SM's L1) and merged in split order
  // with a running max, one round trip of loads per MC splits
  const float4* parts =
      reinterpret_cast<const float4*>(w_acc + static_cast<size_t>(b) * k * D + g * GW);
  const float* m_row = w_m + static_cast<size_t>(b) * k * H + g * HG;
  const float* l_row = w_l + static_cast<size_t>(b) * k * H + g * HG;
  for (int d4 = tid; d4 < GW / 4; d4 += NT) {
    const int h = 4 * d4 / HD;
    float mx = NEG, l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z0 = 0; z0 < k; z0 += MC) {
      float4 x[MC];
      float mz[MC], lz[MC];
#pragma unroll
      for (int j = 0; j < MC; ++j) {
        const int zz = min(z0 + j, k - 1);  // past k: a repeat, weighed 0 below
        x[j] = __ldcg(parts + static_cast<size_t>(zz) * (D / 4) + d4);
        mz[j] = __ldcg(m_row + zz * H + h);
        lz[j] = __ldcg(l_row + zz * H + h);
      }
      float m_new = mx;
#pragma unroll
      for (int j = 0; j < MC; ++j) m_new = fmaxf(m_new, mz[j]);
      const float c = __expf(mx - m_new);
      a.x *= c; a.y *= c; a.z *= c; a.w *= c;
      l *= c;
#pragma unroll
      for (int j = 0; j < MC; ++j) {
        const float w = z0 + j < k ? __expf(mz[j] - m_new) : 0.f;
        a.x = fmaf(w, x[j].x, a.x); a.y = fmaf(w, x[j].y, a.y);
        a.z = fmaf(w, x[j].z, a.z); a.w = fmaf(w, x[j].w, a.w);
        l = fmaf(w, lz[j], l);
      }
      mx = m_new;
    }
    const __nv_bfloat162 lo2 = __floats2bfloat162_rn(a.x / l, a.y / l);
    const __nv_bfloat162 hi2 = __floats2bfloat162_rn(a.z / l, a.w / l);
    uint2 out;
    out.x = *reinterpret_cast<const uint32_t*>(&lo2);
    out.y = *reinterpret_cast<const uint32_t*>(&hi2);
    *reinterpret_cast<uint2*>(o + (size_t)b * D + g * GW + 4 * d4) = out;
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

struct Args {
  const void *q, *kn, *vn;
  long long q_rs, q_hs, kn_rs, kn_hs, vn_rs, vn_hs;
  void *kc, *vc, *o;
  const int* pos;
  int pos_scalar;
  float* ws;
  int* counters;
  int B, S, H, n_split, tile, groups;
  float scale;
  cudaStream_t st;
};

template <int HD>
int launch_f32(const Args& a) {
  decode_attend_kernel<HD><<<dim3(a.H, a.B), NW * 32, 0, a.st>>>(
      static_cast<const float*>(a.q), a.q_rs, a.q_hs, static_cast<const float*>(a.kn), a.kn_rs,
      a.kn_hs, static_cast<const float*>(a.vn), a.vn_rs, a.vn_hs, static_cast<float*>(a.kc),
      static_cast<float*>(a.vc), static_cast<float*>(a.o), a.pos, a.pos_scalar, a.S, a.H,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const Args& a) {
  const int hg = a.H / a.groups, half = a.tile * hg * HD * 2;
  const int smem = ST * 2 * half + ((a.tile * hg * 4 + 15) & ~15) + 8 * ST;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  // once a process: the tick launches this every layer
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      decode_split_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM));
  if (attr) return attr;
  decode_split_kernel<HD><<<dim3(a.n_split, a.B, a.groups), NT, smem, a.st>>>(
      static_cast<const __nv_bfloat16*>(a.q), a.q_rs, a.q_hs,
      static_cast<const __nv_bfloat16*>(a.kn), a.kn_rs, a.kn_hs,
      static_cast<const __nv_bfloat16*>(a.vn), a.vn_rs, a.vn_hs,
      static_cast<__nv_bfloat16*>(a.kc), static_cast<__nv_bfloat16*>(a.vc),
      static_cast<__nv_bfloat16*>(a.o), a.pos, a.pos_scalar, a.ws, a.counters, a.S, a.H, a.tile,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, long long rs, long long hs, int esz) {
  return aligned16(p) && (rs * esz) % 16 == 0 && (hs * esz) % 16 == 0;
}

}  // namespace

// q: element (b, head, e) at q + b * q_rs + head * q_hs + e; kn, vn (null:
// attention alone): the new rows, laid out likewise with their own row and
// head strides, in the caches' dtype; kc, vc: contiguous (B, S, H*hd),
// updated in place at row min(pos, S - 1) when kn is given; o: (B, H*hd).
// pos: (B,) int32 on the device, or null to use pos_scalar for every row;
// positions >= 0.  dtype: 0 = float32 (n_split, tile, groups, ws, counters
// unused), 1 = bfloat16: `groups` head groups of at most 2048 lanes (H a
// multiple), n_split blocks a row and group (1..64), `tile` positions a
// stage (2 * tile * (H / groups) * hd * 2 <= 32 KB), ws: fp32 (B, n_split,
// H*hd + 2H), counters: int32 (B, groups), zero (the kernel leaves them
// zero).  Every pointer and row / head stride 16-byte aligned.  Returns a
// cudaError_t.
extern "C" int decode_attend(const void* q, long long q_rs, long long q_hs, const void* kn,
                             long long kn_rs, long long kn_hs, const void* vn, long long vn_rs,
                             long long vn_hs, void* kc, void* vc, void* o, const void* pos,
                             int pos_scalar, void* ws, void* counters, int B, int S, int H,
                             int hd, int dtype, int n_split, int tile, int groups, float scale,
                             void* stream) {
  Args a{q, kn, vn, q_rs, q_hs, kn_rs, kn_hs, vn_rs, vn_hs, kc, vc, o,
         static_cast<const int*>(pos), pos_scalar, static_cast<float*>(ws),
         static_cast<int*>(counters), B, S, H, n_split, tile, groups, scale,
         static_cast<cudaStream_t>(stream)};
  if (B < 1 || S < 1 || H < 1 || (kn == nullptr) != (vn == nullptr)) return cudaErrorInvalidValue;
  const int esz = dtype == 0 ? 4 : 2;
  if (!aligned(q, q_rs, q_hs, esz) || !aligned16(kc) || !aligned16(vc) || !aligned16(o) ||
      (kn != nullptr && (!aligned(kn, kn_rs, kn_hs, esz) || !aligned(vn, vn_rs, vn_hs, esz))))
    return cudaErrorMisalignedAddress;
  if (dtype == 0 && hd == 64) return launch_f32<64>(a);
  if (dtype == 0 && hd == 128) return launch_f32<128>(a);
  if (dtype != 1 || ws == nullptr || counters == nullptr || n_split < 1 || n_split > 64 ||
      groups < 1 || H % groups != 0 || H / groups * hd > MAX_GW || tile < 1 ||
      2LL * tile * (H / groups) * hd * 2 > 32768)
    return cudaErrorInvalidValue;
  if (hd == 64) return launch_bf16<64>(a);
  if (hd == 128) return launch_bf16<128>(a);
  return cudaErrorInvalidValue;
}
