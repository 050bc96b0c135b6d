// Flash-attention forward for Hopper (sm_90a), plain CUDA C++ behind a C ABI.
//
// Replaces: chainermn_tpu/ops/flash_attention.py :: _fwd_kernel (the
// pallas_call in _flash_fwd).  Same function: causal or full attention over
// (B, S, H, D), fp32 online softmax, O in the input dtype and the per-row
// log-sum-exp in fp32; GQA by letting `group` consecutive q heads read one
// KV head; the ragged tail past S masked here instead of padded.  JAX's
// masking is kept: finite -1e30 sentinel, p zeroed where masked, l floored
// at 1e-37, p rounded to v's dtype before the PV product.
//
// Bound on this card: at the prefill shape (B 8, S 512, H 16, hd 64, bf16,
// causal) the function moves q, k, v and o once, 32 MB, 10 us at 3.35 TB/s;
// its ~4.3 GFLOP take 4 us on the bf16 tensor cores, so the function is
// bandwidth-bound.  This first version does its math on the CUDA cores in
// fp32 (67 TFLOP/s peak, ~64 us for the same work), so as written it is
// bound by operations.  Design: one block per (b*h, 64-row q tile), four
// threads per q row, each holding a quarter of the row's q and accumulator
// in registers; 32-key tiles of K and V are staged in shared memory as fp32
// and read as float4, so each shared load feeds four FMAs; causal tiles
// past the diagonal are never loaded.  Tensor cores (mma/wgmma) and TMA are
// the next step for this kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int TPR = 4;        // threads per query row
constexpr int BK = 32;        // keys per shared-memory tile (one mask bit each)
constexpr int NT = BQ * TPR;  // threads per block
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Thread `sub` of a row owns head dims (c*TPR + sub)*4 + e for chunk c and
// e in [0, 4): the four threads of a row read neighbouring float4s.
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int S, int H, int group,
    float scale, int causal) {
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
      qr[c][e] = row_ok ? to_f(q[q_base + d]) : 0.f;
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
        kv_k = to_f(k[off]);
        kv_v = to_f(v[off]);
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
      const float pv = to_f(from_f<T>(p));  // p.astype(v.dtype)
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][(c * TPR + sub) * 4]);
        acc[c][0] += pv * vv.x;
        acc[c][1] += pv * vv.y;
        acc[c][2] += pv * vv.z;
        acc[c][3] += pv * vv.w;
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
      for (int e = 0; e < 4; ++e)
        o[q_base + (c * TPR + sub) * 4 + e] = from_f<T>(acc[c][e] / lc);
    if (sub == 0) lse[(size_t)bh * S + qi] = m + logf(lc);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
            int S, int H, int group, float scale, int causal, cudaStream_t st) {
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, NT, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), S, H, group, scale, causal);
}

}  // namespace

// q, o: (B, S, H, D); k, v: (B, S, H / group, D); lse: (B, H, S) fp32.
// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int B, int S, int H, int group, int D, int dtype, int causal,
                         float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1 || group < 1 || H % group) return cudaErrorInvalidValue;
  if (dtype == 0 && D == 64) launch<float, 64>(q, k, v, o, lse, B, S, H, group, scale, causal, st);
  else if (dtype == 0 && D == 128) launch<float, 128>(q, k, v, o, lse, B, S, H, group, scale, causal, st);
  else if (dtype == 1 && D == 64) launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, S, H, group, scale, causal, st);
  else if (dtype == 1 && D == 128) launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, S, H, group, scale, causal, st);
  else return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}
