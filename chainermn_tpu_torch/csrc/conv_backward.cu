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
// both are tiled GEMMs whose operand tiles are gathered at the shifted
// position straight from device memory, zero-filled at the border, so no
// shifted copy of a plane exists anywhere.
//
//   dgrad: an implicit GEMM, M = N*H*W pixels, N = Ci, K = taps*Co.  A block
//          owns a 64-pixel x 64-channel tile of dX and walks the taps and Co
//          in steps of 32: the dY tile of the step is read at the shifted
//          pixels, the W tile is a (64 ci x 32 co) slice of W[tap].  One fp32
//          accumulator over all taps; dX is written once.
//   wgrad: per tap a GEMM with M = Ci, N = Co, K = N*H*W (401,408 at 56x56,
//          batch 128).  The long K is split over pixel ranges so that ~528
//          blocks fill the 132 SMs; each block writes its fp32 partial to a
//          slice of a workspace it alone owns, and a second launch sums the
//          slices in a fixed order and rounds.  No atomics: deterministic.
//
// bf16 runs on the tensor cores (mma.sync.m16n8k16, fp32 accumulation): four
// warps in a 2 x 2 grid, each owning 32 x 32 of the 64 x 64 tile.  Tiles sit
// in shared memory as bf16 rows padded by 8 elements (fragment loads hit
// distinct banks); dgrad's tiles are [row][k] (k contiguous, 32-bit fragment
// loads), wgrad's are [k][row] as they come from NHWC memory, and their
// fragments are assembled from two 16-bit loads.  fp32 runs on the CUDA
// cores (FFMA, no TF32): each thread owns a 4 x 8 piece of the tile.  Loads
// are plain (16-byte vectors where the channel counts allow), with no
// pipelining: cp.async or TMA, wgmma and a persistent schedule are this
// kernel's next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int BM = 64;    // tile rows (dgrad: pixels, wgrad: ci)
constexpr int BN = 64;    // tile columns (dgrad: ci, wgrad: co)
constexpr int BK = 32;    // reduction depth per step
constexpr int NT = 128;   // four warps

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// row padding of a shared tile: 16 bytes for bf16 (aligned vector stores,
// conflict-free fragment loads), one element for fp32 (odd row stride)
template <typename T> constexpr int kPad = sizeof(T) == 2 ? 8 : 1;

// An R x C tile into dst (row stride L).  Row r reads src[off(r) + col0 + c]
// for col0 + c < ncols; a row with off(r) < 0, or a column past ncols, is
// zero.  With `vec`, full 8-element chunks of bf16 move as 16-byte vectors.
template <typename T, int R, int C, int L, typename Off>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, Off off, int col0,
                                          int ncols, bool vec) {
  constexpr int CH = C / 8;
  for (int idx = threadIdx.x; idx < R * CH; idx += NT) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const long long o = off(r);
    const int col = col0 + c;
    T* d = dst + r * L + c;
    if constexpr (sizeof(T) == 2) {
      if (vec && o >= 0 && col + 8 <= ncols) {
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src + o + col);
        continue;
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)
      d[e] = (o >= 0 && col + e < ncols) ? src[o + col + e] : from_f<T>(0.f);
  }
}

// ---------------------------------------------------------------------------
// bf16 tile product on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* lo, const bf16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

// A fragment (16 x 16) of rows [m0, m0 + 16), depth [k0, k0 + 16): from a
// [row][k] tile (KMAJOR false) or a [k][row] tile (KMAJOR true).  The same
// loads give a B fragment's (8 columns) two registers with a[0], a[2].
template <bool KMAJOR, int L>
__device__ __forceinline__ uint32_t frag_reg(const bf16* X, int row, int k) {
  if constexpr (KMAJOR)
    return ld_pair(X + k * L + row, X + (k + 1) * L + row);
  else
    return ld32(X + row * L + k);
}

struct MmaAcc {
  float c[2][4][4];

  __device__ __forceinline__ MmaAcc() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;
  }

  // c += A B over one BK step; A holds tile rows (M), B tile columns (N)
  template <bool KMAJOR, int L>
  __device__ __forceinline__ void step(const bf16* A, const bf16* B) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g;
        a[mi][0] = frag_reg<KMAJOR, L>(A, r, kk + 2 * t);
        a[mi][1] = frag_reg<KMAJOR, L>(A, r + 8, kk + 2 * t);
        a[mi][2] = frag_reg<KMAJOR, L>(A, r, kk + 2 * t + 8);
        a[mi][3] = frag_reg<KMAJOR, L>(A, r + 8, kk + 2 * t + 8);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int n = wn + nj * 8 + g;
        b[nj][0] = frag_reg<KMAJOR, L>(B, n, kk + 2 * t);
        b[nj][1] = frag_reg<KMAJOR, L>(B, n, kk + 2 * t + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_bf16(c[mi][nj], a[mi], b[nj]);
    }
  }

  // f(m, n, value) for every accumulator, (m, n) local to the tile
  template <typename F>
  __device__ __forceinline__ void store(F f) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(wm + mi * 16 + g + (e >> 1) * 8, wn + nj * 8 + 2 * t + (e & 1), c[mi][nj][e]);
  }
};

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

template <typename T>
using Acc = std::conditional_t<std::is_same<T, bf16>::value, MmaAcc, FmaAcc>;

// ---------------------------------------------------------------------------
// dgrad: one block per (64 pixels, 64 input channels) tile of dX
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT) conv_dgrad_kernel(const T* __restrict__ dy,
                                                        const T* __restrict__ w,
                                                        T* __restrict__ dx, int N, int H, int W,
                                                        int Ci, int Co, int k, int vec) {
  constexpr int L = BK + kPad<T>;   // [row][k] tiles
  __shared__ __align__(16) T As[BM * L];
  __shared__ __align__(16) T Bs[BN * L];
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
  Acc<T> acc;
  for (int tap = 0; tap < k * k; ++tap) {
    const int dh = tap / k - pad, dw = tap % k - pad;
    for (int co0 = 0; co0 < Co; co0 += BK) {
      __syncthreads();  // the previous step is consumed (and s_* written)
      load_tile<T, BM, BK, L>(As, dy, [&](int r) -> long long {
        const int n = s_n[r];
        const int hs = s_h[r] - dh, ws = s_w[r] - dw;
        if (n < 0 || hs < 0 || hs >= H || ws < 0 || ws >= W) return -1;
        return (((long long)n * H + hs) * W + ws) * Co;
      }, co0, Co, vec);
      load_tile<T, BN, BK, L>(Bs, w, [&](int r) -> long long {
        const int ci = n0 + r;
        return ci < Ci ? ((long long)tap * Ci + ci) * Co : -1;
      }, co0, Co, vec);
      __syncthreads();
      acc.template step<false, L>(As, Bs);
    }
  }

  acc.store([&](int m, int n, float v) {
    const long long p = m0 + m;
    const int ci = n0 + n;
    if (p < P && ci < Ci) dx[p * Ci + ci] = from_f<T>(v);
  });
}

// ---------------------------------------------------------------------------
// wgrad: one block per (64 ci x 64 co tile, tap, pixel split); partials to
// ws[split][tap][ci][co], summed by conv_wgrad_reduce
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT) conv_wgrad_kernel(const T* __restrict__ x,
                                                        const T* __restrict__ dy,
                                                        float* __restrict__ ws, int N, int H,
                                                        int W, int Ci, int Co, int k,
                                                        int steps_per_split, int vec) {
  constexpr int L = BM + kPad<T>;   // [k][row] tiles (BM == BN)
  __shared__ __align__(16) T As[BK * L];
  __shared__ __align__(16) T Bs[BK * L];
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

  Acc<T> acc;
  offsets(p_begin, 0);
  int b = 0;
  for (long long p0 = p_begin; p0 < p_end; p0 += BK, b ^= 1) {
    __syncthreads();  // offsets[b] written, the previous step consumed
    load_tile<T, BK, BM, L>(As, x, [&](int r) { return s_x[b][r]; }, m0, Ci, vec);
    load_tile<T, BK, BN, L>(Bs, dy, [&](int r) { return s_dy[b][r]; }, n0, Co, vec);
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T>
int launch_dgrad(const void* dy, const void* w, void* dx, int N, int H, int W, int Ci, int Co,
                 int k, cudaStream_t st) {
  const long long P = (long long)N * H * W;
  const int vec = Co % 8 == 0 && aligned16(dy) && aligned16(w);
  dim3 grid((unsigned)((P + BM - 1) / BM), (Ci + BN - 1) / BN);
  conv_dgrad_kernel<T><<<grid, NT, 0, st>>>(static_cast<const T*>(dy), static_cast<const T*>(w),
                                            static_cast<T*>(dx), N, H, W, Ci, Co, k, vec);
  return cudaGetLastError();
}

template <typename T>
int launch_wgrad(const void* x, const void* dy, void* dw, void* ws, int N, int H, int W, int Ci,
                 int Co, int k, int steps_per_split, int splits, cudaStream_t st) {
  const int vec = Ci % 8 == 0 && Co % 8 == 0 && aligned16(x) && aligned16(dy);
  const int tiles = ((Ci + BM - 1) / BM) * ((Co + BN - 1) / BN);
  conv_wgrad_kernel<T><<<dim3(tiles, k * k, splits), NT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<float*>(ws), N, H, W, Ci,
      Co, k, steps_per_split, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long count = (long long)k * k * Ci * Co;
  const int blocks = (int)((count + 255) / 256 < 1024 ? (count + 255) / 256 : 1024);
  conv_wgrad_reduce<T><<<blocks, 256, 0, st>>>(static_cast<const float*>(ws),
                                               static_cast<T*>(dw), count, splits);
  return cudaGetLastError();
}

bool shape_ok(int N, int H, int W, int Ci, int Co, int k) {
  return N >= 1 && H >= 1 && W >= 1 && Ci >= 1 && Co >= 1 && (k == 1 || k == 3) &&
         (long long)H * W < (1LL << 31);
}

}  // namespace

// dX (N, H, W, Ci) in dY's dtype from dY (N, H, W, Co) and W (k, k, Ci, Co).
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int conv_dgrad(const void* dy, const void* w, void* dx, int N, int H, int W, int Ci,
                          int Co, int k, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(N, H, W, Ci, Co, k)) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_dgrad<float>(dy, w, dx, N, H, W, Ci, Co, k, st);
  if (dtype == 1) return launch_dgrad<bf16>(dy, w, dx, N, H, W, Ci, Co, k, st);
  return cudaErrorInvalidValue;
}

// dW (k, k, Ci, Co) in X's dtype from X (N, H, W, Ci) and dY (N, H, W, Co);
// ws holds splits * k * k * Ci * Co fp32 partials, split s covering pixels
// [s * steps_per_split * 32, (s + 1) * steps_per_split * 32).
extern "C" int conv_wgrad(const void* x, const void* dy, void* dw, void* ws, int N, int H, int W,
                          int Ci, int Co, int k, int steps_per_split, int splits, int dtype,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shape_ok(N, H, W, Ci, Co, k) || steps_per_split < 1 || splits < 1 || splits > 65535)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_wgrad<float>(x, dy, dw, ws, N, H, W, Ci, Co, k, steps_per_split, splits, st);
  if (dtype == 1)
    return launch_wgrad<bf16>(x, dy, dw, ws, N, H, W, Ci, Co, k, steps_per_split, splits, st);
  return cudaErrorInvalidValue;
}
