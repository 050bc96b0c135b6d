// Fused softmax cross-entropy over a large vocabulary for Hopper (sm_90a),
// plain CUDA C++ behind a C ABI.
//
// Replaces: chainermn_tpu/ops/fused_ce.py :: _stats_kernel (ce_stats),
// _dh_kernel and _dtable_kernel (ce_grads).  Same functions: with
// s = h @ table^T (T x V, fp32 sums),
//
//   ce_stats:  per row the max m, the sum l of exp(s - m) and the target
//              logit (a target outside [0, V) picks nothing);
//   ce_dh:     dh = ds @ table,   ds = (exp(s - lse) - onehot) * dnll,
//              ds rounded to table's dtype;
//   ce_dtable: dtable = ds^T @ h, ds rounded to h's dtype.
//
// Bound on this card: at the training shape (T 8192, V 32768, D 1024, bf16)
// ce_stats does 2*T*V*D = 5.5e11 FLOP (0.56 ms on the bf16 tensor cores),
// ce_dh and ce_dtable 4*T*V*D each (the logits again, then the product;
// 1.11 ms), and the pair as ce_grads shares the logits: 6*T*V*D (1.67 ms).
// Their traffic is ~100 MB: all of them are bound by operations.
//
// bf16 (the training path): one warp-specialised GEMM on the tensor cores
// with four epilogues.  The GEMM: a block of 384 threads owns a 128 x BN
// tile (BN 256 for ce_stats, the ds pass and dh, 128 for dtable, whose M
// is only Vc).  Warpgroup 0 is the producer: one thread keeps a ring of 4
// (BN 256) or 6 (BN 128) stages of 64-deep bf16 tiles filled by TMA
// (128-byte swizzle, tensor maps made on the host by
// cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, passed as
// __grid_constant__), each stage released by an mbarrier pair.  Warpgroups
// 1 and 2 each own 64 rows and run wgmma.mma_async m64nBNk16 with fp32
// accumulators in registers; setmaxnreg moves registers from the producer
// (40) to them (232).  TMA needs 16-byte row strides: D % 8 == 0
// (ops/fused_ce.py pads D with zero columns in a copy where it is not).
// The TMA, mbarrier and wgmma helpers live in hopper.cuh.
//
// ce_stats (bf16): s = h @ table^T over 128 x 256 tiles (both operands
// K-major, as the ds pass below), and the EPI_STATS epilogue turns each
// tile into per-row statistics in registers: a row's 256 columns sit in
// the four threads of a quad (64 each), so the row max is a max over the
// thread's values and two __shfl_xor steps, then the sum of exp(s - max)
// and the target's logit the same way.  TMA fills table rows past V with
// zeros, a logit of 0 and not -inf, so columns >= V are left out of the
// max, the sum and the pick.  Lane 0 of the quad writes the row's (m, l,
// picked) of its V tile to part[3][ceil(V / 256)][T]; a second launch
// merges the tiles in a fixed order (deterministic).  No logit leaves the
// registers.  The T tiles go fastest: the blocks in flight share one or
// two table tiles and h (16 MB at the training shape) stays in the 50 MB
// L2, so the 64 MB table is read from device memory about once; with the V
// tiles fastest (the ds pass's order) every row of T tiles would read it
// again.
//
// bf16 gradients (ce_grads).  The TPU kernels keep a (256, D)
// fp32 accumulator in VMEM across a sequential V (or T) axis: 1 MB at D
// 1024.  On Hopper a block has at most 227 KB of shared memory and an SM
// 256 KB of registers, so no block can hold a full-D accumulator of even 64
// rows (256 KB).  Instead ds itself is made, one chunk of Vc vocabulary
// columns at a time, rounded to bf16 (the rounding JAX applies before both
// products, fused_ce.py:108 and _grads_xla): Vc is chosen so that the chunk
// (T x Vc bf16) is at most 32 MiB and stays in the 50 MB L2 between the
// launch that writes it and those that read it (Vc 2048 at T 8192).  Per
// chunk, in order on one stream:
//
//   1. ds pass   s = h @ table[v0:v0+Vc]^T (M T, N Vc, K D; both operands
//                K-major).  Epilogue in registers: ds = (exp(s - lse) -
//                [v == target]) * dnll, rounded to bf16 and stored 16 bytes
//                a thread (a transpose over the four threads of a quad)
//                into the chunk workspace; the logits never leave
//                registers.  TMA fills rows and columns outside the tensors
//                with zeros, and a zero logit is no zero gradient (exp(-lse)
//                != 0), so columns past the chunk's end are written as 0
//                explicitly and rows past T do not exist in the workspace
//                (TMA reads them back as 0).
//   2. dh        acc = ds_chunk @ table[v0:v0+Vc] (M T, N D, K Vc; B is
//                N-major: the descriptor's transpose bit).  Epilogue: written
//                to a T x D fp32 accumulator on the first chunk, added on the
//                middle ones (red.global.add: no load comes back to the SM),
//                read, added and rounded once to bf16 into dh on the last
//                (straight to dh when there is one chunk).  Each element
//                takes one add per launch and the chunks run in a fixed
//                order: deterministic.
//   3. dtable    dtable[v0:v0+Vc] = ds_chunk^T @ h (M Vc, N D, K T; A is
//                M-major and B N-major: both transpose bits, read straight
//                from the row-major workspace and h).  Each chunk owns its
//                rows, so they are written once in bf16.
//
// ptxas (sm_90a, CUDA 12.9): the GEMM instantiations take 168 registers a
// thread (the launch bound, 65,536 / 384), no spill and no stack;
// setmaxnreg then gives each consumer thread 232 and each producer thread
// 40.  Dynamic shared memory: 197,696 bytes for BN 256 (4 stages of 48 KB)
// and 197,728 for BN 128 (6 of 32 KB), with a 1 KB alignment pad and the
// mbarriers: one block per SM.  The ce_stats merge: 32 registers, 3 KB of
// shared memory.  The fp32 kernels: ce_dh 128 registers, ce_dtable 127, 44
// KB of static shared memory each; ce_stats 64 and 9 KB.
//
// fp32 keeps the first, CUDA-core kernels: wgmma has no fp32 mode and the
// fp32 checks must not run in TF32.  A block of 256 threads owns a 64 x 64
// logits tile (a 4 x 4 micro-tile per thread, D streamed 16 deep through
// shared memory) and recomputes it in every kernel:
//
//   ce_stats   splits V over blocks; each block keeps an online (m, l,
//              picked) for its rows over its V tiles and the merge launch
//              combines the splits.
//   ce_dh      splits V over blocks; after each V tile a block adds
//              ds_tile @ table_tile into its own slice of an fp32 workspace
//              (split, T, D); a last launch sums the splits.
//   ce_dtable  the same with the roles of T and V exchanged.
//
// Every workspace element has one owner, so every result is deterministic.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"


namespace {

using namespace hopper;

constexpr int BT = 64;     // logits tile rows (tokens)
constexpr int BV = 64;     // logits tile columns (vocabulary)
constexpr int BD = 16;     // depth of one shared-memory step of the logits product
constexpr int DC = 64;     // D columns per step of the gradient product
constexpr int PAD = 4;     // row padding of shared tiles (bank spread, float4 aligned)
constexpr int NT = 256;    // threads per block: a 16 x 16 grid of 4 x 4 micro-tiles
constexpr float NEG = -1e30f;

// max / sum over the 16 threads of a half-warp that share a micro-tile row
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct LogitsSmem {
  float hs[BD][BT + PAD];
  float ts[BD][BV + PAD];
};

// acc[i][j] = s[t0 + ty*4 + i][v0 + tx*4 + j], zero outside [0, T) x [0, V).
__device__ __forceinline__ void logits_tile(const float* __restrict__ h,
                                            const float* __restrict__ tab,
                                            int T, int V, int D, int t0, int v0,
                                            LogitsSmem& sm, float acc[4][4]) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += BD) {
    __syncthreads();  // the previous step is consumed
    for (int idx = tid; idx < BD * BT; idx += NT) {
      const int row = idx / BD, dd = idx % BD;
      const int d = d0 + dd;
      const int t = t0 + row, v = v0 + row;
      sm.hs[dd][row] = (t < T && d < D) ? h[(size_t)t * D + d] : 0.f;
      sm.ts[dd][row] = (v < V && d < D) ? tab[(size_t)v * D + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int dd = 0; dd < BD; ++dd) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.hs[dd][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sm.ts[dd][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
  }
}

__global__ void __launch_bounds__(NT) ce_stats_kernel(
    const float* __restrict__ h, const float* __restrict__ tab, const int* __restrict__ tgt,
    int T, int V, int D, int tiles_per_split, float* __restrict__ part) {
  __shared__ __align__(16) LogitsSmem sm;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int t0 = blockIdx.x * BT;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int n_tiles = (V + BV - 1) / BV;
  const int vt_end = min(n_tiles, (split + 1) * tiles_per_split);

  int tg[4];
  float m[4], l[4], pk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    tg[i] = t < T ? tgt[t] : -1;
    m[i] = NEG;
    l[i] = 0.f;
    pk[i] = 0.f;
  }
  for (int vt = split * tiles_per_split; vt < vt_end; ++vt) {
    const int v0 = vt * BV;
    float acc[4][4];
    logits_tile(h, tab, T, V, D, t0, v0, sm, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = v0 + tx * 4 + j;
        if (c < V) {
          tmax = fmaxf(tmax, acc[i][j]);
          if (c == tg[i]) pk[i] += acc[i][j];
        }
      }
      const float m_new = fmaxf(m[i], half_max(tmax));
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (v0 + tx * 4 + j < V) se += expf(acc[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + half_sum(se);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float p = half_sum(pk[i]);
    const int t = t0 + ty * 4 + i;
    if (tx == 0 && t < T) {
      part[((size_t)0 * n_split + split) * T + t] = m[i];
      part[((size_t)1 * n_split + split) * T + t] = l[i];
      part[((size_t)2 * n_split + split) * T + t] = p;
    }
  }
}

// (m, l, picked) of each row from its parts' partials: thread (x, g) of a
// 32 x MERGE_G block merges parts g, g + MERGE_G, ... of row blockIdx.x *
// 32 + x in order, then thread (x, 0) merges the MERGE_G partials in g
// order.  A fixed order: deterministic.
constexpr int MERGE_G = 8;

__global__ void __launch_bounds__(32 * MERGE_G)
    ce_stats_merge_kernel(const float* __restrict__ part, int T, int n_split,
                          float* __restrict__ m, float* __restrict__ l,
                          float* __restrict__ p) {
  __shared__ float sh[3][MERGE_G][32];
  const int x = threadIdx.x, g = threadIdx.y;
  const int t = blockIdx.x * 32 + x;
  float mx = NEG, sum = 0.f, pick = 0.f;
  if (t < T) {
    for (int s = g; s < n_split; s += MERGE_G) mx = fmaxf(mx, part[(size_t)s * T + t]);
    for (int s = g; s < n_split; s += MERGE_G) {
      sum += part[((size_t)n_split + s) * T + t] * expf(part[(size_t)s * T + t] - mx);
      pick += part[((size_t)2 * n_split + s) * T + t];
    }
  }
  sh[0][g][x] = mx;
  sh[1][g][x] = sum;
  sh[2][g][x] = pick;
  __syncthreads();
  if (g != 0 || t >= T) return;
  mx = NEG;
  for (int i = 0; i < MERGE_G; ++i) mx = fmaxf(mx, sh[0][i][x]);
  sum = pick = 0.f;
  for (int i = 0; i < MERGE_G; ++i) {  // a group without parts adds 0 * exp(NEG - mx) = 0
    sum += sh[1][i][x] * expf(sh[0][i][x] - mx);
    pick += sh[2][i][x];
  }
  m[t] = mx;
  l[t] = sum;
  p[t] = pick;
}

// ds for the block's 64 x 64 tile into shared memory.
__device__ __forceinline__ void ds_tile(const float acc[4][4], const int tg[4],
                                        const float lse[4], const float dn[4], int T, int V,
                                        int t0, int v0, float (*ds)[BV + PAD]) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    float out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = v0 + tx * 4 + j;
      float g = 0.f;
      if (t < T && c < V) {
        const float onehot = c == tg[i] ? 1.f : 0.f;
        g = (expf(acc[i][j] - lse[i]) - onehot) * dn[i];
      }
      out[j] = g;
    }
    *reinterpret_cast<float4*>(&ds[ty * 4 + i][tx * 4]) =
        make_float4(out[0], out[1], out[2], out[3]);
  }
}

// dh: block (T tile, V split).  After each V tile, work[split, t, :] +=
// ds_tile @ table[v0:v0+64, :], D in DC-wide steps.
__global__ void __launch_bounds__(NT) ce_dh_kernel(
    const float* __restrict__ h, const float* __restrict__ tab, const int* __restrict__ tgt,
    const float* __restrict__ lse, const float* __restrict__ dnll, int T, int V, int D,
    int tiles_per_split, float* __restrict__ work) {
  __shared__ __align__(16) LogitsSmem sm;
  __shared__ __align__(16) float ds[BT][BV + PAD];
  __shared__ __align__(16) float tb[BV][DC + PAD];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int t0 = blockIdx.x * BT;
  const int split = blockIdx.y;
  const int n_tiles = (V + BV - 1) / BV;
  const int vt_begin = split * tiles_per_split;
  const int vt_end = min(n_tiles, vt_begin + tiles_per_split);
  float* out = work + (size_t)split * T * D;

  int tg[4];
  float ls[4], dn[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    tg[i] = t < T ? tgt[t] : -1;
    ls[i] = t < T ? lse[t] : 0.f;
    dn[i] = t < T ? dnll[t] : 0.f;
  }
  for (int vt = vt_begin; vt < vt_end; ++vt) {
    const int v0 = vt * BV;
    float acc[4][4];
    logits_tile(h, tab, T, V, D, t0, v0, sm, acc);
    ds_tile(acc, tg, ls, dn, T, V, t0, v0, ds);
    for (int dc0 = 0; dc0 < D; dc0 += DC) {
      __syncthreads();  // ds written / the previous table slice consumed
      for (int idx = tid; idx < BV * DC; idx += NT) {
        const int c = idx / DC, dd = idx % DC;
        const int v = v0 + c, d = dc0 + dd;
        tb[c][dd] = (v < V && d < D) ? tab[(size_t)v * D + d] : 0.f;
      }
      __syncthreads();
      float g[4][4] = {};
#pragma unroll 8
      for (int c = 0; c < BV; ++c) {
        const float4 b = *reinterpret_cast<const float4*>(&tb[c][tx * 4]);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = ds[ty * 4 + i][c];
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] += a * bv[j];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty * 4 + i;
        if (t >= T) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = dc0 + tx * 4 + j;
          if (d >= D) continue;
          float* dst = out + (size_t)t * D + d;
          *dst = (vt == vt_begin ? 0.f : *dst) + g[i][j];
        }
      }
    }
  }
}

// dtable: block (V tile, T split).  After each T tile, work[split, v, :] +=
// ds_tile^T @ h[t0:t0+64, :], D in DC-wide steps.
__global__ void __launch_bounds__(NT) ce_dtable_kernel(
    const float* __restrict__ h, const float* __restrict__ tab, const int* __restrict__ tgt,
    const float* __restrict__ lse, const float* __restrict__ dnll, int T, int V, int D,
    int tiles_per_split, float* __restrict__ work) {
  __shared__ __align__(16) LogitsSmem sm;
  __shared__ __align__(16) float ds[BT][BV + PAD];
  __shared__ __align__(16) float hb[BT][DC + PAD];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int v0 = blockIdx.x * BV;
  const int split = blockIdx.y;
  const int n_tiles = (T + BT - 1) / BT;
  const int tt_begin = split * tiles_per_split;
  const int tt_end = min(n_tiles, tt_begin + tiles_per_split);
  float* out = work + (size_t)split * V * D;

  for (int tt = tt_begin; tt < tt_end; ++tt) {
    const int t0 = tt * BT;
    int tg[4];
    float ls[4], dn[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
      tg[i] = t < T ? tgt[t] : -1;
      ls[i] = t < T ? lse[t] : 0.f;
      dn[i] = t < T ? dnll[t] : 0.f;
    }
    float acc[4][4];
    logits_tile(h, tab, T, V, D, t0, v0, sm, acc);
    ds_tile(acc, tg, ls, dn, T, V, t0, v0, ds);
    for (int dc0 = 0; dc0 < D; dc0 += DC) {
      __syncthreads();  // ds written / the previous h slice consumed
      for (int idx = tid; idx < BT * DC; idx += NT) {
        const int r = idx / DC, dd = idx % DC;
        const int t = t0 + r, d = dc0 + dd;
        hb[r][dd] = (t < T && d < D) ? h[(size_t)t * D + d] : 0.f;
      }
      __syncthreads();
      float g[4][4] = {};  // rows: vocabulary v0 + ty*4 + i, columns: D
#pragma unroll 8
      for (int r = 0; r < BT; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(&ds[r][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&hb[r][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] += av[i] * bv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int v = v0 + ty * 4 + i;
        if (v >= V) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = dc0 + tx * 4 + j;
          if (d >= D) continue;
          float* dst = out + (size_t)v * D + d;
          *dst = (tt == tt_begin ? 0.f : *dst) + g[i][j];
        }
      }
    }
  }
}

// out[i] = sum over splits of work[s, i], i < n.
__global__ void sum_splits_kernel(const float* __restrict__ work, size_t n, int n_split,
                                  float* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n_split; ++k) s += work[(size_t)k * n + i];
    out[i] = s;
  }
}


// ---------------------------------------------------------------------------
// bf16: one TMA + wgmma GEMM, four epilogues
// ---------------------------------------------------------------------------

constexpr int GM = 128;          // block tile rows: two consumer warpgroups of 64
constexpr int GK = 64;           // k-tile: one 128-byte swizzle row of bf16
constexpr int GTHREADS = 384;    // warpgroup 0 loads, warpgroups 1-2 multiply
constexpr int ATOM = 64 * GK * 2;     // one 64 x 64 bf16 box: 8 KB
constexpr int DS_TILE = 256;     // the ds pass's and ce_stats' N tile

enum { EPI_DS = 0, EPI_DH = 1, EPI_DTABLE = 2, EPI_STATS = 3 };

struct EpiArgs {
  const float* lse;
  const float* dnll;
  const int* tgt;
  __nv_bfloat16* ds;     // chunk workspace (T, ld), written by EPI_DS
  float* acc;            // (T, D) fp32 dh accumulator (EPI_DH over several chunks)
  __nv_bfloat16* out;    // dh (T, D), or the chunk's rows of dtable (vr, D)
  int T, D, ld;
  int v0, vr;            // the chunk's first vocabulary row and its width (EPI_STATS: 0, V)
  int first, last;       // the chunk's place, for EPI_DH
  float* part;           // (3, parts, T) fp32 per-tile (m, l, picked), written by EPI_STATS
  int parts;             // the V tiles: ceil(V / 256)
};

template <int BN> __host__ __device__ constexpr int gemm_stages() { return BN == 256 ? 4 : 6; }
template <int BN> __host__ __device__ constexpr int stage_bytes() { return (GM + BN) * GK * 2; }
template <int BN> __host__ __device__ constexpr int gemm_smem() {
  return gemm_stages<BN>() * stage_bytes<BN>() + 1024 + 2 * 8 * gemm_stages<BN>();
}

// The per-row values of the ds and stats epilogues for a thread's two rows
// r, r + 8: loaded before the mainloop, so that their latency hides behind
// it (EPI_STATS reads the target alone).
struct DsRows {
  float ls[2], dn[2];
  int tg[2];  // the target's column in the chunk
};

template <int EPI>
__device__ __forceinline__ DsRows ds_rows(const EpiArgs& ep, int r) {
  DsRows x{};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = r + 8 * hh;
    const bool ok = t < ep.T;
    if (EPI == EPI_DS) {
      x.ls[hh] = ok ? ep.lse[t] : 0.f;
      x.dn[hh] = ok ? ep.dnll[t] : 0.f;
    }
    x.tg[hh] = ok ? ep.tgt[t] - ep.v0 : -1;
  }
  return x;
}

// The accumulator of a consumer warpgroup: element 4j + q sits at row
// r = row0 + 16*warp + lane/4 (+8 for q >= 2), column n0 + 8j + 2*(lane%4)
// (+1 for odd q).  Writes the block's share of the GEMM's output per EPI.
template <int BN, int EPI>
__device__ __forceinline__ void epilogue(float (&acc)[BN / 2], const EpiArgs& ep,
                                         const DsRows& x, int r, int n0) {
  const int cq = 2 * (threadIdx.x & 3);
  if (EPI == EPI_STATS) {
    // A row's BN columns sit in one quad, BN / 4 in each thread: the
    // thread's max, sum and pick, then two shuffles across the quad.
    // Columns >= V hold TMA's zero logits: they take no part.
    const bool full = n0 + BN <= ep.vr;
    const int nt = n0 / BN;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = NEG, pk = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * j + cq + e;
          const float s = acc[4 * j + 2 * hh + e];
          if (full || col < ep.vr) {
            mx = fmaxf(mx, s);
            if (col == x.tg[hh]) pk = s;
          }
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (full || n0 + 8 * j + cq + e < ep.vr) se += expf(acc[4 * j + 2 * hh + e] - mx);
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        se += __shfl_xor_sync(0xffffffffu, se, o);
        pk += __shfl_xor_sync(0xffffffffu, pk, o);
      }
      const int t = r + 8 * hh;
      if ((threadIdx.x & 3) == 0 && t < ep.T) {
        ep.part[((size_t)0 * ep.parts + nt) * ep.T + t] = mx;
        ep.part[((size_t)1 * ep.parts + nt) * ep.T + t] = se;
        ep.part[((size_t)2 * ep.parts + nt) * ep.T + t] = pk;
      }
    }
    return;
  }
  if (EPI == EPI_DS) {
    // The four threads of a quad hold, per 8-column group j, two columns
    // each.  Over four groups a 4 x 4 transpose gives each thread all 8
    // columns of one group: 64 contiguous bytes per row and warp.
    const int q = threadIdx.x & 3;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = r + 8 * hh;
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) {
        uint32_t p[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * i + jj;
          const int col = n0 + 8 * j + cq;  // < ld: the grid covers ceil(vr / 256) tiles
          float g0 = 0.f, g1 = 0.f;  // 0 past the chunk: TMA's zero logits are no gradient
          if (col < ep.vr)
            g0 = (expf(acc[4 * j + 2 * hh] - x.ls[hh]) - (col == x.tg[hh] ? 1.f : 0.f)) *
                 x.dn[hh];
          if (col + 1 < ep.vr)
            g1 = (expf(acc[4 * j + 2 * hh + 1] - x.ls[hh]) -
                  (col + 1 == x.tg[hh] ? 1.f : 0.f)) *
                 x.dn[hh];
          p[jj] = pack_bf16(g0, g1);
        }
        quad_transpose(p);
        if (t < ep.T)  // p: columns n0 + 8 * (4i + q) .. + 7 of row t
          *reinterpret_cast<uint4*>(ep.ds + (size_t)t * ep.ld + n0 + 8 * (4 * i + q)) =
              make_uint4(p[0], p[1], p[2], p[3]);
      }
    }
    return;
  }
  const int rows = EPI == EPI_DH ? ep.T : ep.vr;
  if (EPI == EPI_DH && !ep.first && ep.last) {
    // every load before any store, so that they are all in flight at once
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + cq;  // even, and D % 8 == 0: col < D means col + 1 < D
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = r + 8 * hh;
        if (col >= ep.D || t >= rows) continue;
        const float2 o = *reinterpret_cast<const float2*>(ep.acc + (size_t)t * ep.D + col);
        acc[4 * j + 2 * hh] += o.x;
        acc[4 * j + 2 * hh + 1] += o.y;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + cq;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = r + 8 * hh;
      if (col >= ep.D || t >= rows) continue;
      const size_t i = (size_t)t * ep.D + col;
      const float a = acc[4 * j + 2 * hh], b = acc[4 * j + 2 * hh + 1];
      if (EPI == EPI_DTABLE || ep.last)
        *reinterpret_cast<__nv_bfloat162*>(ep.out + i) = __floats2bfloat162_rn(a, b);
      else if (ep.first)
        *reinterpret_cast<float2*>(ep.acc + i) = make_float2(a, b);
      else  // one add per element and launch, in launch order: deterministic
        asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(ep.acc + i), "f"(a), "f"(b)
                     : "memory");
    }
  }
}

// out tile (m tile * 128, n tile * BN) of A (M x K) @ B (K x N), bf16 in,
// fp32 sums, through EPI.  A is K-major (TA 0: map rows are M, box 64 x
// 128) or M-major (TA 1: map rows are K, box 64 x 64); B likewise (TB 0: map
// rows are N, box 64 x BN; TB 1: map rows are K, box 64 x 64).  b_off shifts
// B's map rows (the chunk's first table row).  nk 64-deep k-tiles.  The
// raster: blockIdx.x walks the M tiles with m_fast, the N tiles without.
template <int BN, int EPI, int TA, int TB>
__global__ void __launch_bounds__(GTHREADS, 1)
    ce_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, int nk, int b_off, int m_fast,
                   const EpiArgs ep) {
  constexpr int S = gemm_stages<BN>();
  constexpr int A_BYTES = GM * GK * 2;
  constexpr int STAGE = stage_bytes<BN>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's alignment
  const uint32_t bars = base + S * STAGE;  // full[s] at bars + 8s, empty[s] at bars + 8(S + s)
  const int m0 = (m_fast ? blockIdx.x : blockIdx.y) * GM;
  const int n0 = (m_fast ? blockIdx.y : blockIdx.x) * BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);        // the producer's expect_tx, then the bytes
      mbar_init(bars + 8 * (S + s), 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S;
        const uint32_t full = bars + 8 * s;
        const uint32_t sa = base + s * STAGE, sb = sa + A_BYTES;
        mbar_wait(bars + 8 * (S + s), ((kt / S) & 1) ^ 1);  // the stage's last use is done
        mbar_expect_tx(full, STAGE);
        const int k0 = kt * GK;
        if (TA) {
          tma_load(sa, &map_a, full, m0, k0);
          tma_load(sa + ATOM, &map_a, full, m0 + 64, k0);
        } else {
          tma_load(sa, &map_a, full, k0, m0);
        }
        if (TB) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(sb + j * ATOM, &map_b, full, n0 + 64 * j, b_off + k0);
        } else {
          tma_load(sb, &map_b, full, k0, b_off + n0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;  // rows 64c..64c+63 of the tile
    const int r = m0 + 64 * c + 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
    DsRows x{};
    if (EPI == EPI_DS || EPI == EPI_STATS) x = ds_rows<EPI>(ep, r);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % S;
      const uint32_t sa = base + s * STAGE + c * ATOM, sb = base + s * STAGE + A_BYTES;
      mbar_wait(bars + 8 * s, (kt / S) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GK / 16; ++kk) {
        const uint64_t da =
            TA ? smem_desc(sa + kk * 2048, ATOM, 1024) : smem_desc(sa + kk * 32, 16, 1024);
        const uint64_t db =
            TB ? smem_desc(sb + kk * 2048, ATOM, 1024) : smem_desc(sb + kk * 32, 16, 1024);
        wgmma_ss<TA, TB>(acc, da, db);
      }
      wgmma_commit();
      fence_regs(acc);
      // k-tile kt stays in flight; kt - 1 is done, so its stage goes back
      wgmma_wait<1>();
      fence_regs(acc);
      if (kt > 0 && (threadIdx.x & 31) == 0) mbar_arrive(bars + 8 * (S + (kt - 1) % S));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    epilogue<BN, EPI>(acc, ep, x, r, n0);
  }
}

template <int BN, int EPI, int TA, int TB>
int allow_smem() {
  return static_cast<int>(cudaFuncSetAttribute(ce_gemm_kernel<BN, EPI, TA, TB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               gemm_smem<BN>()));
}

// (m_rows x n_cols) output through EPI: one block per 128 x BN tile, the M
// tiles fastest with m_fast, else the N tiles.
template <int BN, int EPI, int TA, int TB>
int gemm(const CUtensorMap& a, const CUtensorMap& b, int m_rows, int n_cols, int nk, int b_off,
         const EpiArgs& ep, cudaStream_t st, int m_fast = 0) {
  const unsigned mt = (m_rows + GM - 1) / GM, nt = (n_cols + BN - 1) / BN;
  if ((m_fast ? nt : mt) > 65535u) return cudaErrorInvalidConfiguration;
  const dim3 grid = m_fast ? dim3(mt, nt) : dim3(nt, mt);
  ce_gemm_kernel<BN, EPI, TA, TB><<<grid, GTHREADS, gemm_smem<BN>(), st>>>(a, b, nk, b_off, m_fast,
                                                                           ep);
  return static_cast<int>(cudaGetLastError());
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

int splits(int n_tiles, int tiles_per_split) {
  return (n_tiles + tiles_per_split - 1) / tiles_per_split;
}

// fp32 dh or dtable: the split kernel, then the sum of the splits.
int grads_f32(bool dh, const void* h, const void* tab, const int* tgt, const float* lse,
              const float* dnll, void* out, float* work, int T, int V, int D,
              int tiles_per_split, cudaStream_t st) {
  const float* hf = static_cast<const float*>(h);
  const float* tf = static_cast<const float*>(tab);
  size_t n;
  int n_split;
  if (dh) {
    n_split = splits((V + BV - 1) / BV, tiles_per_split);
    ce_dh_kernel<<<dim3((T + BT - 1) / BT, n_split), NT, 0, st>>>(
        hf, tf, tgt, lse, dnll, T, V, D, tiles_per_split, work);
    n = (size_t)T * D;
  } else {
    n_split = splits((T + BT - 1) / BT, tiles_per_split);
    ce_dtable_kernel<<<dim3((V + BV - 1) / BV, n_split), NT, 0, st>>>(
        hf, tf, tgt, lse, dnll, T, V, D, tiles_per_split, work);
    n = (size_t)V * D;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_splits_kernel<<<1024, 256, 0, st>>>(work, n, n_split, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int T, int V, int D, int tiles_per_split) {
  return T < 1 || V < 1 || D < 1 || tiles_per_split < 1;
}

// bf16 ce_stats: the EPI_STATS GEMM over every 128 x 256 logits tile, one
// part per V tile, the T tiles fastest.
int stats_bf16(const void* h, const void* tab, const int* tgt, float* part, int T, int V, int D,
               int parts, cudaStream_t st) {
  CUtensorMap h_k, tab_k;
  int err;
  if ((err = make_map_2d(&h_k, h, D, T, GK, GM)) ||
      (err = make_map_2d(&tab_k, tab, D, V, GK, DS_TILE)) ||
      (err = allow_smem<DS_TILE, EPI_STATS, 0, 0>()))
    return err;
  EpiArgs ep{};
  ep.tgt = tgt;
  ep.T = T;
  ep.D = D;
  ep.vr = V;
  ep.part = part;
  ep.parts = parts;
  return gemm<DS_TILE, EPI_STATS, 0, 0>(h_k, tab_k, T, V, cdiv(D, GK), 0, ep, st, 1);
}

}  // namespace

// h: (T, D), table: (V, D) of one dtype (0 = float32, 1 = bfloat16);
// targets: (T,) int32; m, l, picked: (T,) fp32.  The caller's plan
// (ops/fused_ce.py :: _stats_plan), checked here: V goes in `parts` parts
// of `per` tiles of `tile_v` columns, and `work` holds (3, parts, T) fp32,
// each part's (m, l, picked), merged in a fixed order by a second launch.
// float32: tile_v 64 (the CUDA-core kernel, one block column per part).
// bfloat16: tile_v 256, per 1 (the wgmma GEMM, a part per 128 x 256
// tile), D % 8 == 0, h and table 16-byte aligned.  Two
// launches on `stream`; returns 0, the first cudaError_t, or a negated
// CUresult of cuTensorMapEncodeTiled.
extern "C" int ce_stats(const void* h, const void* tab, const void* tgt, void* m, void* l,
                        void* picked, void* work, int T, int V, int D, int tile_v, int per,
                        int parts, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(T, V, D, per) || tile_v < 1 || parts != splits(cdiv(V, tile_v), per))
    return cudaErrorInvalidValue;
  const int* tg = static_cast<const int*>(tgt);
  float* part = static_cast<float*>(work);
  int err;
  if (dtype == 0) {
    if (tile_v != BV) return cudaErrorInvalidValue;
    ce_stats_kernel<<<dim3(cdiv(T, BT), parts), NT, 0, st>>>(
        static_cast<const float*>(h), static_cast<const float*>(tab), tg, T, V, D, per, part);
    err = static_cast<int>(cudaGetLastError());
  } else if (dtype == 1) {
    if (tile_v != DS_TILE || per != 1 || D % 8 != 0) return cudaErrorInvalidValue;
    if (!aligned16(h) || !aligned16(tab)) return cudaErrorMisalignedAddress;
    err = stats_bf16(h, tab, tg, part, T, V, D, parts, st);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err) return err;
  ce_stats_merge_kernel<<<cdiv(T, 32), dim3(32, MERGE_G), 0, st>>>(
      part, T, parts, static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(picked));
  return static_cast<int>(cudaGetLastError());
}

// fp32 dh (T, D).  V is split as in ce_stats; `work` holds n_split * T * D
// fp32.  lse, dnll: (T,) fp32.  bf16 goes through ce_grads.
extern "C" int ce_dh(const void* h, const void* tab, const void* tgt, const void* lse,
                     const void* dnll, void* dh, void* work, int T, int V, int D,
                     int tiles_per_split, int dtype, void* stream) {
  if (bad_shape(T, V, D, tiles_per_split) || dtype != 0) return cudaErrorInvalidValue;
  return grads_f32(true, h, tab, static_cast<const int*>(tgt), static_cast<const float*>(lse),
                   static_cast<const float*>(dnll), dh, static_cast<float*>(work), T, V, D,
                   tiles_per_split, static_cast<cudaStream_t>(stream));
}

// fp32 dtable (V, D).  T is split into groups of `tiles_per_split` 64-row
// tiles; `work` holds n_split * V * D fp32.  bf16 goes through ce_grads.
extern "C" int ce_dtable(const void* h, const void* tab, const void* tgt, const void* lse,
                         const void* dnll, void* dtable, void* work, int T, int V, int D,
                         int tiles_per_split, int dtype, void* stream) {
  if (bad_shape(T, V, D, tiles_per_split) || dtype != 0) return cudaErrorInvalidValue;
  return grads_f32(false, h, tab, static_cast<const int*>(tgt), static_cast<const float*>(lse),
                   static_cast<const float*>(dnll), dtable, static_cast<float*>(work), T, V, D,
                   tiles_per_split, static_cast<cudaStream_t>(stream));
}

// bf16 dh (T, D) and/or dtable (V, D), either null when not wanted, through
// V chunks of Vc columns (Vc % 128 == 0; the last chunk may be shorter).
// `work` holds the ds chunk, T x ld bf16 with ld = Vc rounded up to 256,
// then (at the next multiple of 256 bytes) the T x D fp32 dh accumulator
// when dh is wanted over more than one chunk.  h, table and work 16-byte
// aligned, D % 8 == 0 (TMA's row strides).  dtype must be 1.  Up to three
// launches per chunk on `stream`; returns 0, the first cudaError_t, or a
// negated CUresult of cuTensorMapEncodeTiled.
extern "C" int ce_grads(const void* h, const void* tab, const void* tgt, const void* lse,
                        const void* dnll, void* dh, void* dtable, void* work, int T, int V,
                        int D, int Vc, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 1 || T < 1 || V < 1 || D < 1 || D % 8 != 0 || Vc < GM || Vc % GM != 0 ||
      (dh == nullptr && dtable == nullptr) || work == nullptr)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(tab) |
       reinterpret_cast<uintptr_t>(work)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const int ld = cdiv(Vc, DS_TILE) * DS_TILE;
  auto* ds = static_cast<__nv_bfloat16*>(work);
  auto* acc = reinterpret_cast<float*>(static_cast<char*>(work) +
                                       ((size_t)T * ld * 2 + 255) / 256 * 256);
  CUtensorMap h_k, tab_k, ds_k, tab_mn, ds_mn, h_mn;
  int err;
  if ((err = make_map_2d(&h_k, h, D, T, GK, GM)) || (err = make_map_2d(&tab_k, tab, D, V, GK, DS_TILE)) ||
      (err = make_map_2d(&ds_k, ds, ld, T, GK, GM)) || (err = make_map_2d(&tab_mn, tab, D, V, 64, GK)) ||
      (err = make_map_2d(&ds_mn, ds, ld, T, 64, GK)) || (err = make_map_2d(&h_mn, h, D, T, 64, GK)))
    return err;
  if ((err = allow_smem<DS_TILE, EPI_DS, 0, 0>()) || (err = allow_smem<256, EPI_DH, 0, 1>()) ||
      (err = allow_smem<128, EPI_DTABLE, 1, 1>()))
    return err;
  EpiArgs ep{static_cast<const float*>(lse), static_cast<const float*>(dnll),
             static_cast<const int*>(tgt), ds, acc, nullptr, T, D, ld, 0, 0, 0, 0};
  const int n_chunks = cdiv(V, Vc);
  for (int c = 0; c < n_chunks; ++c) {
    ep.v0 = c * Vc;
    ep.vr = V - ep.v0 < Vc ? V - ep.v0 : Vc;
    ep.first = c == 0;
    ep.last = c == n_chunks - 1;
    // 1. ds = f(h @ table[v0:v0+vr]^T) into the workspace
    if ((err = gemm<DS_TILE, EPI_DS, 0, 0>(h_k, tab_k, T, ep.vr, cdiv(D, GK), ep.v0, ep, st)))
      return err;
    // 2. dh (+)= ds @ table[v0:v0+vr]
    if (dh != nullptr) {
      ep.out = static_cast<__nv_bfloat16*>(dh);
      if ((err = gemm<256, EPI_DH, 0, 1>(ds_k, tab_mn, T, D, cdiv(ep.vr, GK), ep.v0, ep, st)))
        return err;
    }
    // 3. dtable[v0:v0+vr] = ds^T @ h
    if (dtable != nullptr) {
      ep.out = static_cast<__nv_bfloat16*>(dtable) + (size_t)ep.v0 * D;
      if ((err = gemm<128, EPI_DTABLE, 1, 1>(ds_mn, h_mn, ep.vr, D, cdiv(T, GK), 0, ep, st)))
        return err;
    }
  }
  return 0;
}
