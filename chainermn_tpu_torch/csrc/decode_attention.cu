// One decode tick's attention for Hopper (sm_90a), plain CUDA C++ behind a C ABI.
//
// Replaces: chainermn_tpu/ops/decode_attention.py :: _kernel (the
// pallas_call in decode_attend).  Same function: one query row per batch
// row against the flat cache (B, S, H*hd), positions past pos masked, all
// math in fp32 with no rounding of p.  It takes pos per row, so one kernel
// serves both the closed batch (a scalar pos, broadcast) and the serving
// tick, where every slot sits at its own length (the per-row einsum
// attention of chainermn_tpu/parallel/decode.py computes the same function
// in fp32).
//
// Bound on this card: the tick reads each row's K and V up to pos once; at
// 8 slots x 1024 positions x 1024 lanes in bf16 that is 32 MB, 10 us at
// 3.35 TB/s, against 67 MFLOP, so it is bandwidth-bound.  Design: one block
// of 8 warps per (b, head); each position is read by a group of lanes with
// one 16-byte load per lane, several groups per warp, so a warp streams
// whole cache rows; each group keeps its own online softmax (m, l, acc) in
// registers and the groups are merged once through shared memory.  The
// block stops at pos[b] instead of streaming the whole cache.  One block per
// (b, head) leaves S unsplit: splitting it across blocks (flash-decoding)
// is the next step when B*H is small against the card's 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;  // warps per block
constexpr float NEG = -1e30f;

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

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

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NW * 32) decode_attend_kernel(
    const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
    T* __restrict__ o, const int* __restrict__ pos, int pos_scalar, int S, int H,
    float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
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

  const int p = pos != nullptr ? pos[b] : pos_scalar;
  const int n = min(p, S - 1) + 1;  // positions [0, n) are valid

  float qv[VEC];
  load16(q + (size_t)b * D + h * HD + li * VEC, qv);
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
    o[(size_t)b * D + h * HD + d] = from_f<T>(a / lt);
  }
}

template <typename T, int HD>
void launch(const void* q, const void* kc, const void* vc, void* o, const int* pos,
            int pos_scalar, int B, int S, int H, float scale, cudaStream_t st) {
  dim3 grid(H, B);
  decode_attend_kernel<T, HD><<<grid, NW * 32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<T*>(o), pos, pos_scalar, S, H, scale);
}

}  // namespace

// q, o: (B, H*hd); kc, vc: (B, S, H*hd); pos: (B,) int32 on the device, or
// null to use pos_scalar for every row.  dtype: 0 = float32, 1 = bfloat16.
// Returns the launch's cudaError_t.
extern "C" int decode_attend(const void* q, const void* kc, const void* vc, void* o,
                             const void* pos, int pos_scalar, int B, int S, int H,
                             int hd, int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (B < 1 || S < 1 || H < 1) return cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64) launch<float, 64>(q, kc, vc, o, p, pos_scalar, B, S, H, scale, st);
  else if (dtype == 0 && hd == 128) launch<float, 128>(q, kc, vc, o, p, pos_scalar, B, S, H, scale, st);
  else if (dtype == 1 && hd == 64) launch<__nv_bfloat16, 64>(q, kc, vc, o, p, pos_scalar, B, S, H, scale, st);
  else if (dtype == 1 && hd == 128) launch<__nv_bfloat16, 128>(q, kc, vc, o, p, pos_scalar, B, S, H, scale, st);
  else return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}
