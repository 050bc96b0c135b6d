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
//   ce_dtable: dtable = ds^T @ h, ds rounded to h's dtype;
//
// each recomputing its 64 x 64 logits tiles in registers: a logits tile
// never goes to global memory.  Ragged T, V and D are masked here.
//
// Bound on this card: at the training shape (T 8192, V 32768, D 1024,
// bf16) ce_stats does 2*T*V*D = 5.5e11 FLOP (0.56 ms on the bf16 tensor
// cores) against ~84 MB of traffic, and ce_dh / ce_dtable twice that: all
// three are bound by operations.  This first version does its products on
// the CUDA cores in fp32 (67 TFLOP/s peak, so >= 8 ms for ce_stats), with a
// classic shared-memory SGEMM tile: a block of 256 threads owns a 64 x 64
// logits tile, each thread a 4 x 4 micro-tile, and the D axis streams
// through shared memory 16 deep.  The TPU kernels carry their sums across
// a sequential grid axis in VMEM; blocks on Hopper run in no order, so:
//
//   ce_stats   splits V over blocks; each block keeps an online (m, l,
//              picked) for its rows over its V tiles and a second launch
//              merges the splits.
//   ce_dh      splits V over blocks; the 64 x D fp32 accumulator of a block
//              is too large for registers, so after each V tile the block
//              adds ds_tile @ table_tile into its OWN slice of an fp32
//              workspace (split, T, D); a last launch sums the splits and
//              rounds once.
//   ce_dtable  the same with the roles of T and V exchanged.
//
// Every workspace element has one owner, so the result is deterministic.
// Tensor cores (mma/wgmma) and TMA are these kernels' next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BT = 64;     // logits tile rows (tokens)
constexpr int BV = 64;     // logits tile columns (vocabulary)
constexpr int BD = 16;     // depth of one shared-memory step of the logits product
constexpr int DC = 64;     // D columns per step of the gradient product
constexpr int PAD = 4;     // row padding of shared tiles (bank spread, float4 aligned)
constexpr int NT = 256;    // threads per block: a 16 x 16 grid of 4 x 4 micro-tiles
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

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
template <typename E>
__device__ __forceinline__ void logits_tile(const E* __restrict__ h, const E* __restrict__ tab,
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
      sm.hs[dd][row] = (t < T && d < D) ? to_f(h[(size_t)t * D + d]) : 0.f;
      sm.ts[dd][row] = (v < V && d < D) ? to_f(tab[(size_t)v * D + d]) : 0.f;
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

template <typename E>
__global__ void __launch_bounds__(NT) ce_stats_kernel(
    const E* __restrict__ h, const E* __restrict__ tab, const int* __restrict__ tgt, int T,
    int V, int D, int tiles_per_split, float* __restrict__ part) {
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

__global__ void ce_stats_merge_kernel(const float* __restrict__ part, int T, int n_split,
                                      float* __restrict__ m, float* __restrict__ l,
                                      float* __restrict__ p) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  float mx = NEG;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, part[(size_t)s * T + t]);
  float sum = 0.f, pick = 0.f;
  for (int s = 0; s < n_split; ++s) {
    sum += part[((size_t)n_split + s) * T + t] * expf(part[(size_t)s * T + t] - mx);
    pick += part[((size_t)2 * n_split + s) * T + t];
  }
  m[t] = mx;
  l[t] = sum;
  p[t] = pick;
}

// ds for the block's 64 x 64 tile into shared memory, rounded to R.
template <typename R>
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
      out[j] = round_to<R>(g);
    }
    *reinterpret_cast<float4*>(&ds[ty * 4 + i][tx * 4]) =
        make_float4(out[0], out[1], out[2], out[3]);
  }
}

// dh: block (T tile, V split).  After each V tile, work[split, t, :] +=
// ds_tile @ table[v0:v0+64, :], D in DC-wide steps.
template <typename E>
__global__ void __launch_bounds__(NT) ce_dh_kernel(
    const E* __restrict__ h, const E* __restrict__ tab, const int* __restrict__ tgt,
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
    ds_tile<E>(acc, tg, ls, dn, T, V, t0, v0, ds);  // ds.astype(table.dtype)
    for (int dc0 = 0; dc0 < D; dc0 += DC) {
      __syncthreads();  // ds written / the previous table slice consumed
      for (int idx = tid; idx < BV * DC; idx += NT) {
        const int c = idx / DC, dd = idx % DC;
        const int v = v0 + c, d = dc0 + dd;
        tb[c][dd] = (v < V && d < D) ? to_f(tab[(size_t)v * D + d]) : 0.f;
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
template <typename E>
__global__ void __launch_bounds__(NT) ce_dtable_kernel(
    const E* __restrict__ h, const E* __restrict__ tab, const int* __restrict__ tgt,
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
    ds_tile<E>(acc, tg, ls, dn, T, V, t0, v0, ds);  // ds.astype(h.dtype)
    for (int dc0 = 0; dc0 < D; dc0 += DC) {
      __syncthreads();  // ds written / the previous h slice consumed
      for (int idx = tid; idx < BT * DC; idx += NT) {
        const int r = idx / DC, dd = idx % DC;
        const int t = t0 + r, d = dc0 + dd;
        hb[r][dd] = (t < T && d < D) ? to_f(h[(size_t)t * D + d]) : 0.f;
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

// out[i] = (sum over splits of work[s, i]) rounded to E, i < n.
template <typename E>
__global__ void sum_splits_kernel(const float* __restrict__ work, size_t n, int n_split,
                                  E* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n_split; ++k) s += work[(size_t)k * n + i];
    out[i] = from_f<E>(s);
  }
}

int splits(int n_tiles, int tiles_per_split) {
  return (n_tiles + tiles_per_split - 1) / tiles_per_split;
}

template <typename E>
int grads(bool dh, const void* h, const void* tab, const int* tgt, const float* lse,
          const float* dnll, void* out, float* work, int T, int V, int D,
          int tiles_per_split, cudaStream_t st) {
  size_t n;
  int n_split;
  if (dh) {
    n_split = splits((V + BV - 1) / BV, tiles_per_split);
    ce_dh_kernel<E><<<dim3((T + BT - 1) / BT, n_split), NT, 0, st>>>(
        static_cast<const E*>(h), static_cast<const E*>(tab), tgt, lse, dnll, T, V, D,
        tiles_per_split, work);
    n = (size_t)T * D;
  } else {
    n_split = splits((T + BT - 1) / BT, tiles_per_split);
    ce_dtable_kernel<E><<<dim3((V + BV - 1) / BV, n_split), NT, 0, st>>>(
        static_cast<const E*>(h), static_cast<const E*>(tab), tgt, lse, dnll, T, V, D,
        tiles_per_split, work);
    n = (size_t)V * D;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_splits_kernel<E><<<1024, 256, 0, st>>>(work, n, n_split, static_cast<E*>(out));
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int T, int V, int D, int tiles_per_split) {
  return T < 1 || V < 1 || D < 1 || tiles_per_split < 1;
}

}  // namespace

// h: (T, D), table: (V, D) of one dtype (0 = float32, 1 = bfloat16);
// targets: (T,) int32.  V is split into groups of `tiles_per_split`
// 64-wide tiles, one block column each; `work` holds 3 * n_split * T fp32
// (n_split = ceil(ceil(V / 64) / tiles_per_split)).  m, l, picked: (T,)
// fp32.  Two launches on `stream`; returns the first cudaError_t.
extern "C" int ce_stats(const void* h, const void* tab, const void* tgt, void* m, void* l,
                        void* picked, void* work, int T, int V, int D, int tiles_per_split,
                        int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(T, V, D, tiles_per_split)) return cudaErrorInvalidValue;
  const int n_split = splits((V + BV - 1) / BV, tiles_per_split);
  const dim3 grid((T + BT - 1) / BT, n_split);
  const int* tg = static_cast<const int*>(tgt);
  float* part = static_cast<float*>(work);
  if (dtype == 0)
    ce_stats_kernel<float><<<grid, NT, 0, st>>>(static_cast<const float*>(h),
                                                static_cast<const float*>(tab), tg, T, V,
                                                D, tiles_per_split, part);
  else if (dtype == 1)
    ce_stats_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(tab), tg, T,
        V, D, tiles_per_split, part);
  else
    return cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_stats_merge_kernel<<<(T + 255) / 256, 256, 0, st>>>(
      part, T, n_split, static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(picked));
  return static_cast<int>(cudaGetLastError());
}

// dh (T, D) in h's dtype.  V is split as in ce_stats; `work` holds
// n_split * T * D fp32.  lse, dnll: (T,) fp32.
extern "C" int ce_dh(const void* h, const void* tab, const void* tgt, const void* lse,
                     const void* dnll, void* dh, void* work, int T, int V, int D,
                     int tiles_per_split, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(T, V, D, tiles_per_split)) return cudaErrorInvalidValue;
  const int* tg = static_cast<const int*>(tgt);
  const float* ls = static_cast<const float*>(lse);
  const float* dn = static_cast<const float*>(dnll);
  float* w = static_cast<float*>(work);
  if (dtype == 0) return grads<float>(true, h, tab, tg, ls, dn, dh, w, T, V, D, tiles_per_split, st);
  if (dtype == 1)
    return grads<__nv_bfloat16>(true, h, tab, tg, ls, dn, dh, w, T, V, D, tiles_per_split, st);
  return cudaErrorInvalidValue;
}

// dtable (V, D) in the table's dtype.  T is split into groups of
// `tiles_per_split` 64-row tiles; `work` holds n_split * V * D fp32.
extern "C" int ce_dtable(const void* h, const void* tab, const void* tgt, const void* lse,
                         const void* dnll, void* dtable, void* work, int T, int V, int D,
                         int tiles_per_split, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(T, V, D, tiles_per_split)) return cudaErrorInvalidValue;
  const int* tg = static_cast<const int*>(tgt);
  const float* ls = static_cast<const float*>(lse);
  const float* dn = static_cast<const float*>(dnll);
  float* w = static_cast<float*>(work);
  if (dtype == 0)
    return grads<float>(false, h, tab, tg, ls, dn, dtable, w, T, V, D, tiles_per_split, st);
  if (dtype == 1)
    return grads<__nv_bfloat16>(false, h, tab, tg, ls, dn, dtable, w, T, V, D,
                                tiles_per_split, st);
  return cudaErrorInvalidValue;
}
