// Convolution backward (weight and input gradients) for Hopper (sm_90a),
// plain CUDA C++ behind a C ABI.
//
// Replaces: chainermn_tpu/ops/conv_backward.py :: _wgrad_kernel and
// _dgrad_kernel (the pallas_calls in conv3x3_wgrad / conv3x3_dgrad).  Same
// functions, for a SAME, stride-1, k x k conv (k in {1, 3}) over NHWC
// activations and HWIO weights, pad = (k - 1) / 2, tap (kh, kw) shifted by
// (dh, dw) = (kh - pad, kw - pad):
//
//   wgrad: dW[tap, ci, co] = sum_{n,h,w} X[n, h+dh, w+dw, ci] dY[n, h, w, co]
//   dgrad: dX[n, h, w, ci] = sum_{tap,co} dY[n, h-dh, w-dw, co] W[tap, ci, co]
//
// with zeros outside the plane (the TPU kernel's border mask).  Every sum is
// fp32; wgrad rounds once to X's dtype, dgrad once to dY's.
//
// Bound on this card: at ResNet-50's eligible shapes (batch 128: 56x56x64,
// 28x28x128, 14x14x256, k 3) each function does 2*N*H*W*9*Ci*Co = 29.6 GFLOP,
// 0.030 ms on the bf16 tensor cores, and moves X (or dX) and dY once (51 MB
// each at 56x56x64, 0.031 ms at 3.35 TB/s): operations and bytes bound it
// about equally at 56x56, operations at the other two.
//
// Design.  The TPU kernels hold a few whole images in VMEM and apply each
// tap as a roll of the flattened plane plus a mask, one tap per sequential
// grid step, carrying the sums in scratch.  None of that carries over: here
// both are tiled GEMMs whose operand tiles are read at the shifted position
// straight from device memory, zero at the border, so no shifted copy of a
// plane exists anywhere.
//
//   dgrad: an implicit GEMM, M = N*H*W pixels, N = Ci, K = taps*Co.  One
//          fp32 accumulator over all taps; dX is written once, with no
//          split, no workspace and no atomics: deterministic.
//   wgrad: per tap a GEMM with M = Ci, N = Co, K = N*H*W (401,408 at 56x56,
//          batch 128), the long K split over blocks that each write an fp32
//          partial to a slice of a workspace they alone own; a second launch
//          sums the slices in a fixed order and rounds.  No atomics:
//          deterministic.
//
// bf16 dgrad (TMA + wgmma).  A block owns a box of box_h x box_w dX pixels
// of one image (at most tile_m = 256, or 128 with TN 256) and a TN-wide ci
// tile (64, 128 or 256), the ci tiles fastest in the grid so that a dY box's tiles run
// together.  K walks the taps and, per tap, the 64-channel panels of Co.
// Warpgroup 0 keeps a ring of 4-8 stages full, each holding the dY box at
// the tap-shifted coordinates (co0, w0 - dw, h0 - dh, img) of a 4-D map
// over dY as (C, W, H, N) (TMA's zero fill past the plane is the SAME
// border) and the W panel of the tap (rows ci0 .. ci0 + TN of W viewed as
// (k*k*Ci, Co), 64 co).  Both operands are K-major with a 128-byte swizzle
// (a pixel's 64 channels are one 128-byte line), the form of fused_ce's ds
// pass.  Pixel rows past the box are never written by TMA and need no
// zeroing: row i of the product depends on row i of A alone, and those dX
// rows are not stored.  Consumer warpgroups 1 and 2 each own 64 * MB rows
// (MB = tile_m / 128: with TN <= 128 two m64 wgmmas per k step, so that
// each W panel serves 256 pixels) and run wgmma m64nTNk16 into fp32
// registers; the epilogue rounds once to bf16 and stores 16 bytes a thread
// after a transpose over the quad.  ops/conv_backward.py :: _dgrad_plan
// picks the box, TN and tile_m (rows used at ResNet-50's shapes: 224 / 256
// at 56x56, 196 / 256 at 28x28, 98 / 128 at 14x14); the kernel derives
// only the geometry.  Channels not a multiple of 8 are padded with zeros in
// a copy by the wrapper, which drops the pad from dX.  ptxas (sm_90a): 168
// registers (the launch bound; setmaxnreg 40 / 232), no spill, for (TN,
// MB) = (64, 2), (128, 2) and (256, 1); 4 HGMMA in the SASS (8 with MB 2).
//
// bf16 wgrad (TMA + wgmma).  The producer loads tiled 4-D TMA boxes (64
// channels, box_w, box_h, 1 image) over X and dY as (C, W, H, N), X at the
// tap-shifted coordinates (w0 + dw, h0 + dh): TMA's zero fill past the
// plane is the SAME border, and past the box's end in dY it makes those
// pixels add nothing.  A box never crosses an image, so a
// split's pixel range needs no image bookkeeping.  Boxes tile each image as
// ceil(H / box_h) x ceil(W / box_w); box_h and box_w come from the wrapper
// (ops/conv_backward.py :: _wgrad_plan, which also picks CN and the splits)
// so that a box holds at most 128 pixels (64 for a 256-wide tile, to keep
// four stages in shared memory) with little waste at 56, 28 and 14 (112 /
// 112 / 56 pixels).  The box's rows
// past its pixel count, up to the next multiple of 16 (the wgmma depth),
// are zeroed once per stage.  TMA's im2col mode would waste no rows at
// 14 x 14 but needs a second descriptor kind and corner arithmetic; the
// tiled boxes reuse the maps of the other kernels.
//   A block owns (tap, a 64-ci x CN-co tile, a split of the boxes), with the
// taps varying fastest in the grid, so the nine taps of one box range run
// together and dY's boxes come from the L2.  CN = 64, 128 or 256 covers Co
// (one co tile for ResNet-50's three shapes).  Warpgroup 0 keeps a ring of
// 4 stages (an X box and CN / 64 dY panels) full; consumer warpgroups 1 and
// 2 take alternate boxes, not alternate rows, so Ci = 64 keeps both busy,
// and each runs wgmma m64nCNk16 with A = X^T M-major and B = dY N-major
// (both transpose bits, as in fused_ce's dtable product; B's panels one box
// apart: LBO = the box's bytes).  At the end consumer 1's partial joins
// consumer 0's through shared memory, and one fp32 slice is written.  The
// splits are sized so the grid fills about two waves of the card's SMs.
//   Channels not a multiple of 8 (TMA's 16-byte strides) are padded with
// zeros in a copy by the wrapper, which drops the pad from dW.
//   ptxas (sm_90a, CUDA 12.9): 168 registers (the launch bound; setmaxnreg
// 40 / 232), no spill, for CN = 64, 128 and 256; the k loop over a box is
// not unrolled (its depth is the box's), so ptxas adds a warpgroup.arrive
// before it.
//
// fp32 wgrad and dgrad run on the CUDA cores (FFMA, no TF32): each thread
// owns a 4 x 8 piece of a 64 x 64 tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 64;    // fp32 tile rows (dgrad: pixels, wgrad: ci)
constexpr int BN = 64;    // fp32 tile columns (dgrad: ci, wgrad: co)
constexpr int BK = 32;    // fp32 reduction depth per step
constexpr int NT = 128;   // fp32: four warps
constexpr int kPad = 1;   // fp32 row padding of a shared tile: an odd row stride

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// An R x C fp32 tile into dst (row stride L).  Row r reads src[off(r) + col0
// + c] for col0 + c < ncols; a row with off(r) < 0, or a column past ncols,
// is zero.
template <int R, int C, int L, typename Off>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, Off off,
                                          int col0, int ncols) {
  constexpr int CH = C / 8;
  for (int idx = threadIdx.x; idx < R * CH; idx += NT) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const long long o = off(r);
    const int col = col0 + c;
    float* d = dst + r * L + c;
#pragma unroll
    for (int e = 0; e < 8; ++e) d[e] = (o >= 0 && col + e < ncols) ? src[o + col + e] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// fp32 tile product on the CUDA cores: thread (tm, tn) owns rows tm + 16 i
// and columns tn + 8 j of the tile
// ---------------------------------------------------------------------------

struct FmaAcc {
  float c[4][8];

  __device__ __forceinline__ FmaAcc() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[i][j] = 0.f;
  }

  template <bool KMAJOR, int L>
  __device__ __forceinline__ void step(const float* A, const float* B) {
    const int tm = threadIdx.x % 16, tn = threadIdx.x / 16;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tm + 16 * i;
        a[i] = KMAJOR ? A[k * L + r] : A[r * L + k];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tn + 8 * j;
        b[j] = KMAJOR ? B[k * L + n] : B[n * L + k];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }

  template <typename F>
  __device__ __forceinline__ void store(F f) const {
    const int tm = threadIdx.x % 16, tn = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) f(tm + 16 * i, tn + 8 * j, c[i][j]);
  }
};

// ---------------------------------------------------------------------------
// dgrad, fp32: one block per (64 pixels, 64 input channels) tile of dX
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) conv_dgrad_f32_kernel(const float* __restrict__ dy,
                                                            const float* __restrict__ w,
                                                            float* __restrict__ dx, int N,
                                                            int H, int W, int Ci, int Co,
                                                            int k) {
  constexpr int L = BK + kPad;   // [row][k] tiles
  __shared__ __align__(16) float As[BM * L];
  __shared__ __align__(16) float Bs[BN * L];
  __shared__ int s_n[BM], s_h[BM], s_w[BM];

  const long long P = (long long)N * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  if (threadIdx.x < BM) {
    const long long p = m0 + threadIdx.x;
    const int hw = H * W;
    s_n[threadIdx.x] = p < P ? (int)(p / hw) : -1;
    const int rem = (int)(p % hw);
    s_h[threadIdx.x] = rem / W;
    s_w[threadIdx.x] = rem % W;
  }

  const int pad = (k - 1) / 2;
  FmaAcc acc;
  for (int tap = 0; tap < k * k; ++tap) {
    const int dh = tap / k - pad, dw = tap % k - pad;
    for (int co0 = 0; co0 < Co; co0 += BK) {
      __syncthreads();  // the previous step is consumed (and s_* written)
      load_tile<BM, BK, L>(As, dy, [&](int r) -> long long {
        const int n = s_n[r];
        const int hs = s_h[r] - dh, ws = s_w[r] - dw;
        if (n < 0 || hs < 0 || hs >= H || ws < 0 || ws >= W) return -1;
        return (((long long)n * H + hs) * W + ws) * Co;
      }, co0, Co);
      load_tile<BN, BK, L>(Bs, w, [&](int r) -> long long {
        const int ci = n0 + r;
        return ci < Ci ? ((long long)tap * Ci + ci) * Co : -1;
      }, co0, Co);
      __syncthreads();
      acc.template step<false, L>(As, Bs);
    }
  }

  acc.store([&](int m, int n, float v) {
    const long long p = m0 + m;
    const int ci = n0 + n;
    if (p < P && ci < Ci) dx[p * Ci + ci] = v;
  });
}

// ---------------------------------------------------------------------------
// dgrad, bf16: TMA + wgmma.  One block per (box of dX pixels, TN-wide Ci
// tile), the Ci tiles fastest; warpgroup 0 loads, warpgroups 1 and 2 each
// own 64 * MB rows of the box and walk every (tap, Co panel) into one fp32
// accumulator; dX is written once.
// ---------------------------------------------------------------------------

struct DgradPlan {
  int N, H, W, Ci, Co, k;
  int box_h, box_w, nh, nw;     // a box: box_h x box_w pixels of one image
  int ct, kc;                   // Ci tiles of TN, 64-channel panels of Co
};

// A stage: the dY box as 128 * MB pixel rows of 128 bytes (TMA writes
// box_h * box_w of them; the rest only feed dX rows that are not stored),
// then the W panel, TN rows of 64 co.
template <int TN, int MB> __host__ __device__ constexpr int dg_a_bytes() { return 128 * MB * 128; }
template <int TN, int MB> __host__ __device__ constexpr int dg_stage() {
  return dg_a_bytes<TN, MB>() + TN * 128;
}
template <int TN, int MB> __host__ __device__ constexpr int dg_stages() {
  return (200 << 10) / dg_stage<TN, MB>() > 8 ? 8 : (200 << 10) / dg_stage<TN, MB>();
}
template <int TN, int MB> __host__ __device__ constexpr int dg_smem() {
  return dg_stages<TN, MB>() * dg_stage<TN, MB>() + 1024 + 16 * dg_stages<TN, MB>();
}

template <int TN, int MB>
__global__ void __launch_bounds__(384, 1)
    conv_dgrad_wgmma_kernel(const __grid_constant__ CUtensorMap map_dy,
                            const __grid_constant__ CUtensorMap map_w, bf16* __restrict__ dx,
                            const DgradPlan a) {
  constexpr int A_BYTES = dg_a_bytes<TN, MB>();
  constexpr int STAGE = dg_stage<TN, MB>();
  constexpr int S = dg_stages<TN, MB>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's alignment
  const uint32_t bars = base + S * STAGE;  // full[s] at bars + 8s, empty[s] at bars + 8(S + s)
  const int tile = blockIdx.x % a.ct, box = blockIdx.x / a.ct;
  const int ci0 = tile * TN;
  const int wi = box % a.nw, r = box / a.nw;
  const int h0 = (r % a.nh) * a.box_h, w0 = wi * a.box_w, img = r / a.nh;
  const int pad = (a.k - 1) / 2;
  const int nk = a.k * a.k * a.kc;
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
      const uint32_t tx = (a.box_h * a.box_w + TN) * 128;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S;
        const uint32_t full = bars + 8 * s, sa = base + s * STAGE;
        mbar_wait(bars + 8 * (S + s), ((kt / S) & 1) ^ 1);  // the stage's last use is done
        mbar_expect_tx(full, tx);
        const int tap = kt / a.kc, c0 = (kt % a.kc) * 64;
        const int dh = tap / a.k - pad, dw = tap % a.k - pad;
        // dY at the tap's shift: coordinates off the plane arrive as zeros (SAME)
        tma_load(sa, &map_dy, full, c0, w0 - dw, h0 - dh, img);
        // W[tap] rows ci0 .. ci0 + TN; those past Ci (the next tap's, or
        // zeros) feed only dX columns that are not stored
        tma_load(sa + A_BYTES, &map_w, full, c0, tap * a.Ci + ci0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  float acc[MB][TN / 2];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[mb][i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S;
    const uint32_t sa = base + s * STAGE + c * MB * 8192, sb = base + s * STAGE + A_BYTES;
    mbar_wait(bars + 8 * s, (kt / S) & 1);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) fence_regs(acc[mb]);
    wgmma_fence();
    // A = dY pixels x 64 co, B = W rows (ci) x 64 co: both K-major, the ds
    // pass's TN form; a 16-deep k step moves both starts by 32 bytes
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
        wgmma_ss<0, 0>(acc[mb], smem_desc(sa + mb * 8192 + kk * 32, 16, 1024),
                       smem_desc(sb + kk * 32, 16, 1024));
    wgmma_commit();
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) fence_regs(acc[mb]);
    // step kt stays in flight; kt - 1 is done, so its stage goes back
    wgmma_wait<1>();
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) fence_regs(acc[mb]);
    if (kt > 0 && lane == 0) mbar_arrive(bars + 8 * (S + (kt - 1) % S));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) fence_regs(acc[mb]);

  // Row p of the box is pixel (h0 + p / box_w, w0 + p % box_w).  A quad's
  // 4 x 4 transpose gives each thread 8 contiguous channels: 16-byte stores.
  const int rows = a.box_h * a.box_w, q = lane & 3;
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = (c * MB + mb) * 64 + 16 * warp + (lane >> 2) + 8 * hh;
      const int y = h0 + p / a.box_w, x = w0 + p % a.box_w;
      const bool ok = p < rows && y < a.H && x < a.W;
      bf16* row = dx + (((size_t)img * a.H + y) * a.W + x) * a.Ci + ci0;
#pragma unroll
      for (int i = 0; i < TN / 32; ++i) {
        uint32_t pk[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * i + jj;
          pk[jj] = pack_bf16(acc[mb][4 * j + 2 * hh], acc[mb][4 * j + 2 * hh + 1]);
        }
        quad_transpose(pk);
        const int col = 8 * (4 * i + q);  // Ci % 8 == 0: all 8 in or all out
        if (ok && ci0 + col < a.Ci)
          *reinterpret_cast<uint4*>(row + col) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      }
    }
}

// ---------------------------------------------------------------------------
// wgrad, fp32: one block per (64 ci x 64 co tile, tap, pixel split);
// partials to ws[split][tap][ci][co], summed by conv_wgrad_reduce
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) conv_wgrad_f32_kernel(const float* __restrict__ x,
                                                            const float* __restrict__ dy,
                                                            float* __restrict__ ws, int N,
                                                            int H, int W, int Ci, int Co, int k,
                                                            int steps_per_split) {
  constexpr int L = BM + kPad;   // [k][row] tiles (BM == BN)
  __shared__ __align__(16) float As[BK * L];
  __shared__ __align__(16) float Bs[BK * L];
  __shared__ long long s_x[2][BK], s_dy[2][BK];   // row offsets, double-buffered

  const int tiles_n = (Co + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  const int tap = blockIdx.y, taps = k * k;
  const int pad = (k - 1) / 2;
  const int dh = tap / k - pad, dw = tap % k - pad;
  const long long P = (long long)N * H * W;
  const long long p_begin = (long long)blockIdx.z * steps_per_split * BK;
  const long long p_end = min(P, p_begin + (long long)steps_per_split * BK);
  const int hw = H * W;

  // the X and dY row offsets of pixels [p0, p0 + BK) into buffer b
  auto offsets = [&](long long p0, int b) {
    if (threadIdx.x < BK) {
      const long long p = p0 + threadIdx.x;
      long long ox = -1, ody = -1;
      if (p < p_end) {
        const int n = (int)(p / hw), rem = (int)(p % hw);
        const int hs = rem / W + dh, wsft = rem % W + dw;
        ody = p * Co;
        if (hs >= 0 && hs < H && wsft >= 0 && wsft < W)
          ox = (((long long)n * H + hs) * W + wsft) * Ci;
      }
      s_x[b][threadIdx.x] = ox;
      s_dy[b][threadIdx.x] = ody;
    }
  };

  FmaAcc acc;
  offsets(p_begin, 0);
  int b = 0;
  for (long long p0 = p_begin; p0 < p_end; p0 += BK, b ^= 1) {
    __syncthreads();  // offsets[b] written, the previous step consumed
    load_tile<BK, BM, L>(As, x, [&](int r) { return s_x[b][r]; }, m0, Ci);
    load_tile<BK, BN, L>(Bs, dy, [&](int r) { return s_dy[b][r]; }, n0, Co);
    offsets(p0 + BK, b ^ 1);
    __syncthreads();
    acc.template step<true, L>(As, Bs);
  }

  float* out = ws + ((long long)blockIdx.z * taps + tap) * Ci * Co;
  acc.store([&](int m, int n, float v) {
    const int ci = m0 + m, co = n0 + n;
    if (ci < Ci && co < Co) out[(long long)ci * Co + co] = v;
  });
}

// ---------------------------------------------------------------------------
// wgrad, bf16: TMA + wgmma.  One block per (tap, 64 ci x CN co tile, split
// of the pixel boxes), taps fastest; warpgroup 0 loads, warpgroups 1 and 2
// take alternate boxes and sum their partials through shared memory.
// ---------------------------------------------------------------------------

constexpr int WG_STAGES = 4;    // even: stage s belongs to consumer s % 2

struct WgradPlan {
  int N, H, W, Ci, Co, k;
  int box_h, box_w, nh, nw;     // a box: box_h x box_w pixels of one image
  int r16;                      // the box's pixel rows rounded up to 16
  int per, steps;               // boxes per split, boxes in all
};

template <int CN> __host__ __device__ constexpr int wg_red_bytes() { return 64 * (CN + 4) * 4; }

template <int CN>
__global__ void __launch_bounds__(384, 1)
    conv_wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                            const __grid_constant__ CUtensorMap map_dy, float* __restrict__ ws,
                            const WgradPlan a) {
  constexpr int PN = CN / 64;                      // dY panels of 64 channels
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base;                      // full[s] at +8s, empty[s] at +8(S + s)
  const uint32_t ring = base + 1024;
  const int xb = a.r16 * 128;                      // one box: r16 pixel rows of 128 bytes
  const int stage = xb * (1 + PN);                 // X, then the dY panels
  const int rows = a.box_h * a.box_w;

  const int taps = a.k * a.k;
  const int nt = (a.Co + CN - 1) / CN, ct = (a.Ci + 63) / 64;
  int id = blockIdx.x;
  const int tap = id % taps;
  id /= taps;
  const int tile = id % (ct * nt), split = id / (ct * nt);
  const int ci0 = (tile / nt) * 64, co0 = (tile % nt) * CN;
  const int pad = (a.k - 1) / 2, dh = tap / a.k - pad, dw = tap % a.k - pad;
  const int i0 = split * a.per, n = min(a.steps, i0 + a.per) - i0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                  // the producer's expect_tx, then the bytes
      mbar_init(bars + 8 * (WG_STAGES + s), 4);    // the owning consumer's four warps
    }
    mbar_init_fence();
  }
  // Pixel rows past the box (rows .. r16) are never written by TMA: zero
  // them once, so that the last 16-deep k step adds 0 x 0.
  if (rows < a.r16) {
    const int tail = (a.r16 - rows) * 128 / 16;    // 16-byte words per box
    for (int idx = threadIdx.x; idx < WG_STAGES * (1 + PN) * tail; idx += blockDim.x) {
      const int bx = idx / tail, w = idx % tail;
      const uint32_t at = ring + bx * xb + rows * 128 + 16 * w;
      *reinterpret_cast<uint4*>(smem_raw + (at - raw)) = make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async();
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < n; ++kt) {
        const int s = kt % WG_STAGES;
        const uint32_t full = bars + 8 * s, sx = ring + s * stage;
        mbar_wait(bars + 8 * (WG_STAGES + s), ((kt / WG_STAGES) & 1) ^ 1);
        mbar_expect_tx(full, (1 + PN) * rows * 128);
        const int step = i0 + kt;
        const int wi = step % a.nw, r = step / a.nw;
        const int h0 = (r % a.nh) * a.box_h, w0 = wi * a.box_w, img = r / a.nh;
        // X at the tap's shift: coordinates off the plane arrive as zeros (SAME)
        tma_load(sx, &map_x, full, ci0, w0 + dw, h0 + dh, img);
#pragma unroll
        for (int j = 0; j < PN; ++j)  // dY rows off the plane are zeros: they add nothing
          tma_load(sx + (1 + j) * xb, &map_dy, full, co0 + 64 * j, w0, h0, img);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  float acc[CN / 2];
#pragma unroll
  for (int i = 0; i < CN / 2; ++i) acc[i] = 0.f;
  int prev = -1;
  for (int kt = c; kt < n; kt += 2) {
    const int s = kt % WG_STAGES;
    const uint32_t sx = ring + s * stage, sdy = sx + xb;
    mbar_wait(bars + 8 * s, (kt / WG_STAGES) & 1);
    fence_regs(acc);
    wgmma_fence();
    // A = X^T: M-major (ci along a line, pixels down); B = dY: N-major, its
    // 64-channel panels one box apart (LBO); a 16-pixel step is 2 KB
#pragma unroll 1
    for (int kk = 0; kk < a.r16 / 16; ++kk)
      wgmma_ss<1, 1>(acc, smem_desc(sx + kk * 2048, 8192, 1024),
                     smem_desc(sdy + kk * 2048, xb, 1024));
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<1>();  // this box stays in flight; the previous one is done
    fence_regs(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(bars + 8 * (WG_STAGES + prev % WG_STAGES));
    prev = kt;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (prev >= 0 && lane == 0) mbar_arrive(bars + 8 * (WG_STAGES + prev % WG_STAGES));

  // consumer 1's partial joins consumer 0's through the (now idle) ring
  constexpr int LD = CN + 4;
  float* red = reinterpret_cast<float*>(smem_raw + (ring - raw));
  const int r0 = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  asm volatile("bar.sync 1, 256;" ::: "memory");   // both consumers are done with the ring
  if (c == 1) {
#pragma unroll
    for (int j = 0; j < CN / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(red + (r0 + 8 * hh) * LD + 8 * j + cq) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
  asm volatile("bar.sync 1, 256;" ::: "memory");
  if (c == 1) return;
  float* out = ws + ((size_t)split * taps + tap) * a.Ci * a.Co;
#pragma unroll
  for (int j = 0; j < CN / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ci = ci0 + r0 + 8 * hh, co = co0 + 8 * j + cq;  // Co % 8 == 0: co + 1 < Co
      if (ci >= a.Ci || co >= a.Co) continue;
      const float2 o = *reinterpret_cast<const float2*>(red + (r0 + 8 * hh) * LD + 8 * j + cq);
      *reinterpret_cast<float2*>(out + (size_t)ci * a.Co + co) =
          make_float2(acc[4 * j + 2 * hh] + o.x, acc[4 * j + 2 * hh + 1] + o.y);
    }
}

template <typename T>
__global__ void conv_wgrad_reduce(const float* __restrict__ ws, T* __restrict__ dw,
                                  long long count, int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += ws[sp * count + i];
    dw[i] = from_f<T>(s);
  }
}

int launch_dgrad_f32(const void* dy, const void* w, void* dx, int N, int H, int W, int Ci,
                     int Co, int k, cudaStream_t st) {
  const long long P = (long long)N * H * W;
  dim3 grid((unsigned)((P + BM - 1) / BM), (Ci + BN - 1) / BN);
  conv_dgrad_f32_kernel<<<grid, NT, 0, st>>>(static_cast<const float*>(dy),
                                             static_cast<const float*>(w),
                                             static_cast<float*>(dx), N, H, W, Ci, Co, k);
  return cudaGetLastError();
}

template <int TN, int MB>
int launch_dgrad_wgmma(const void* dy, const void* w, void* dx, const DgradPlan& a,
                       cudaStream_t st) {
  CUtensorMap mdy, mw;
  int err;
  if ((err = make_map_4d(&mdy, dy, a.Co, a.W, a.H, a.N, 64, a.box_w, a.box_h, 1)) ||
      (err = make_map_2d(&mw, w, a.Co, a.k * a.k * a.Ci, 64, TN)))
    return err;
  constexpr int smem = dg_smem<TN, MB>();
  if ((err = static_cast<int>(cudaFuncSetAttribute(
           conv_dgrad_wgmma_kernel<TN, MB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))))
    return err;
  const long long blocks = (long long)a.ct * a.N * a.nh * a.nw;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  conv_dgrad_wgmma_kernel<TN, MB><<<(unsigned)blocks, 384, smem, st>>>(
      mdy, mw, static_cast<bf16*>(dx), a);
  return cudaGetLastError();
}

int launch_dgrad_bf16(const void* dy, const void* w, void* dx, int N, int H, int W, int Ci,
                      int Co, int k, int box_h, int box_w, int tile_n, int tile_m,
                      cudaStream_t st) {
  if (Ci % 8 || Co % 8 || box_h < 1 || box_w < 1 || box_h > 256 || box_w > 256 ||
      (tile_n != 64 && tile_n != 128 && tile_n != 256) ||
      tile_m != (tile_n <= 128 ? 256 : 128) || box_h * box_w > tile_m)
    return cudaErrorInvalidValue;
  if (!aligned16(dy) || !aligned16(w) || !aligned16(dx)) return cudaErrorMisalignedAddress;
  const DgradPlan a{N, H, W, Ci, Co, k, box_h, box_w, (H + box_h - 1) / box_h,
                    (W + box_w - 1) / box_w, (Ci + tile_n - 1) / tile_n, (Co + 63) / 64};
  if (tile_n == 64) return launch_dgrad_wgmma<64, 2>(dy, w, dx, a, st);
  if (tile_n == 128) return launch_dgrad_wgmma<128, 2>(dy, w, dx, a, st);
  return launch_dgrad_wgmma<256, 1>(dy, w, dx, a, st);
}

template <typename T>
int reduce_wgrad(const void* ws, void* dw, int k, int Ci, int Co, int splits, cudaStream_t st) {
  const long long count = (long long)k * k * Ci * Co;
  const int blocks = (int)((count + 255) / 256 < 1024 ? (count + 255) / 256 : 1024);
  conv_wgrad_reduce<T><<<blocks, 256, 0, st>>>(static_cast<const float*>(ws),
                                               static_cast<T*>(dw), count, splits);
  return cudaGetLastError();
}

int launch_wgrad_f32(const void* x, const void* dy, void* dw, void* ws, int N, int H, int W,
                     int Ci, int Co, int k, int steps_per_split, int splits, cudaStream_t st) {
  const int tiles = ((Ci + BM - 1) / BM) * ((Co + BN - 1) / BN);
  conv_wgrad_f32_kernel<<<dim3(tiles, k * k, splits), NT, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<float*>(ws), N, H,
      W, Ci, Co, k, steps_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_wgrad<float>(ws, dw, k, Ci, Co, splits, st);
}

template <int CN>
int launch_wgrad_wgmma(const void* x, const void* dy, const WgradPlan& a, void* ws, int splits,
                       cudaStream_t st) {
  CUtensorMap mx, mdy;
  int err;
  if ((err = make_map_4d(&mx, x, a.Ci, a.W, a.H, a.N, 64, a.box_w, a.box_h, 1)) ||
      (err = make_map_4d(&mdy, dy, a.Co, a.W, a.H, a.N, 64, a.box_w, a.box_h, 1)))
    return err;
  const int stage = a.r16 * 128 * (1 + CN / 64);
  const int ring = WG_STAGES * stage > wg_red_bytes<CN>() ? WG_STAGES * stage : wg_red_bytes<CN>();
  const int smem = 2048 + ring;  // the 1 KB alignment pad, the barriers, the ring
  if ((err = static_cast<int>(cudaFuncSetAttribute(
           conv_wgrad_wgmma_kernel<CN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))))
    return err;
  const long long blocks =
      (long long)a.k * a.k * ((a.Ci + 63) / 64) * ((a.Co + CN - 1) / CN) * splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  conv_wgrad_wgmma_kernel<CN><<<(unsigned)blocks, 384, smem, st>>>(
      mx, mdy, static_cast<float*>(ws), a);
  return cudaGetLastError();
}

int launch_wgrad_bf16(const void* x, const void* dy, void* dw, void* ws, int N, int H, int W,
                      int Ci, int Co, int k, int per, int splits, int box_h, int box_w,
                      int bn, cudaStream_t st) {
  if (Ci % 8 || Co % 8 || box_h < 1 || box_w < 1 || box_h > 256 || box_w > 256 ||
      (bn != 64 && bn != 128 && bn != 256))
    return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(dy)) return cudaErrorMisalignedAddress;
  WgradPlan a{N, H, W, Ci, Co, k, box_h, box_w, (H + box_h - 1) / box_h,
              (W + box_w - 1) / box_w, (box_h * box_w + 15) / 16 * 16, per, 0};
  const long long steps = (long long)N * a.nh * a.nw;
  if (steps > 0x7fffffffLL || (long long)per * splits < steps ||
      (long long)per * (splits - 1) >= steps)
    return cudaErrorInvalidValue;
  a.steps = (int)steps;
  int err = bn == 64    ? launch_wgrad_wgmma<64>(x, dy, a, ws, splits, st)
            : bn == 128 ? launch_wgrad_wgmma<128>(x, dy, a, ws, splits, st)
                        : launch_wgrad_wgmma<256>(x, dy, a, ws, splits, st);
  if (err) return err;
  return reduce_wgrad<bf16>(ws, dw, k, Ci, Co, splits, st);
}

bool shape_ok(int N, int H, int W, int Ci, int Co, int k) {
  return N >= 1 && H >= 1 && W >= 1 && Ci >= 1 && Co >= 1 && (k == 1 || k == 3) &&
         (long long)H * W < (1LL << 31);
}

}  // namespace

// dX (N, H, W, Ci) in dY's dtype from dY (N, H, W, Co) and W (k, k, Ci, Co).
// dtype: 0 = float32 (box_h, box_w, tile_n and tile_m are not read), 1 =
// bfloat16: the caller's plan (ops/conv_backward.py :: _dgrad_plan), checked
// here: boxes of box_h x box_w pixels of one image (ceil(H / box_h) x
// ceil(W / box_w) per image) of at most tile_m pixels, tile_n (64, 128 or
// 256) ci columns a block, tile_m 256 with tile_n <= 128, else 128; Ci and Co
// multiples of 8, dy, w and dx 16-byte aligned (TMA).  Returns a
// cudaError_t, or a negated CUresult of cuTensorMapEncodeTiled.
extern "C" int conv_dgrad(const void* dy, const void* w, void* dx, int N, int H, int W, int Ci,
                          int Co, int k, int box_h, int box_w, int tile_n, int tile_m,
                          int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(N, H, W, Ci, Co, k)) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_dgrad_f32(dy, w, dx, N, H, W, Ci, Co, k, st);
  if (dtype == 1)
    return launch_dgrad_bf16(dy, w, dx, N, H, W, Ci, Co, k, box_h, box_w, tile_n, tile_m, st);
  return cudaErrorInvalidValue;
}

// dW (k, k, Ci, Co) in X's dtype from X (N, H, W, Ci) and dY (N, H, W, Co);
// ws holds splits * k * k * Ci * Co fp32 partials, summed in split order.
// fp32: split s covers pixels [s * per * 32, (s + 1) * per * 32); box_h,
// box_w and tile_n are not read.  bf16: the pixels go in boxes of box_h x
// box_w of one image (ceil(H / box_h) x ceil(W / box_w) per image,
// image-major, W fastest), split s covering boxes [s * per, (s + 1) * per);
// tile_n (64, 128 or 256) co columns a block; Ci and Co multiples of 8, x
// and dy 16-byte aligned (TMA).  A box whose four stages do not fit in
// shared memory fails at cudaFuncSetAttribute.  Returns a cudaError_t, or a
// negated CUresult of cuTensorMapEncodeTiled.
extern "C" int conv_wgrad(const void* x, const void* dy, void* dw, void* ws, int N, int H, int W,
                          int Ci, int Co, int k, int per, int splits, int box_h, int box_w,
                          int tile_n, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(N, H, W, Ci, Co, k) || per < 1 || splits < 1 || splits > 65535)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_wgrad_f32(x, dy, dw, ws, N, H, W, Ci, Co, k, per, splits, st);
  if (dtype == 1)
    return launch_wgrad_bf16(x, dy, dw, ws, N, H, W, Ci, Co, k, per, splits, box_h, box_w,
                             tile_n, st);
  return cudaErrorInvalidValue;
}
