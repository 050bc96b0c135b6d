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
// and serves all R rows, so the launch is bandwidth-bound: the beam tick's
// generated window (8 x 2048 x 1024 lanes, bf16) is 67 MB, 20 us at 3.35
// TB/s, against 8*4*2048*1024*4 = 268 MFLOP.  Design: one block of 8 warps
// per (b, kv-head).  A group of lanes reads one position with one 16-byte
// load per lane (several groups per warp, so a warp streams whole cache
// rows); the R query rows sit in shared memory and each group keeps R
// online-softmax states (m, l, acc) in registers, so a K/V row loaded from
// HBM is used by every row before the next is read.  The groups are merged
// row by row through shared memory at the end.  The segment may be a window
// of a longer cache: it takes the batch stride, and reads nothing beyond
// its S rows.  S is not split across blocks: at B*H_kv = 32 (the GQA tick)
// that leaves SMs idle, and splitting S is the next step.

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int HD, int NR>
__global__ void __launch_bounds__(NW * 32) beam_attend_kernel(
    const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
    const int8_t* __restrict__ mask, const int* __restrict__ pos,
    float* __restrict__ acc_o, float* __restrict__ m_o, float* __restrict__ l_o,
    int pos_scalar, int mode, int S, int H, int R, long long kv_stride,
    float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LPP = HD / VEC;        // lanes reading one position
  constexpr int PPW = 32 / LPP;        // positions per warp step
  constexpr int NG = NW * PPW;         // position groups per block
  static_assert(LPP <= 32 && 32 % LPP == 0, "head_dim does not tile a warp");

  __shared__ __align__(16) float q_s[NR][HD];
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

  for (int i = threadIdx.x; i < NR * HD; i += NW * 32) {
    const int r = i / HD, e = i % HD;
    q_s[r][e] = r < R ? to_f(q[(size_t)(b * R + r) * D + h * HD + e]) : 0.f;
  }
  __syncthreads();

  int n = S;  // positions [0, n) are read
  if (mode == 2) n = min(pos != nullptr ? pos[b] : pos_scalar, S - 1) + 1;
  const size_t row0 = (size_t)b * kv_stride + h * HD + li * VEC;
  const int8_t* mrow = mask + (size_t)b * R * S;

  float m[NR], l[NR], acc[NR][VEC];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  }

  // every lane of a warp runs the same trip count, so the shuffles below
  // always see the whole warp
  for (int t0 = warp * PPW; t0 < n; t0 += NG) {
    const int t = t0 + g_in;
    const bool valid = t < n;
    float part[NR];
    if (valid) {
      float kv[VEC];
      load16(kc + row0 + (size_t)t * D, kv);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float4* qp = reinterpret_cast<const float4*>(&q_s[r][li * VEC]);
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < VEC / 4; ++c) {
          const float4 x = qp[c];
          s += x.x * kv[4 * c] + x.y * kv[4 * c + 1] + x.z * kv[4 * c + 2] +
               x.w * kv[4 * c + 3];
        }
        part[r] = s;
      }
    } else {
#pragma unroll
      for (int r = 0; r < NR; ++r) part[r] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
#pragma unroll
      for (int off = LPP / 2; off > 0; off /= 2)
        part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
    }
    if (valid) {
      float vv[VEC];
      load16(vc + row0 + (size_t)t * D, vv);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (r < R) {
          float s = part[r] * scale;
          if (mode == 1 && mrow[(size_t)r * S + t] <= 0) s = NEG;
          const float m_new = fmaxf(m[r], s);
          const float corr = expf(m[r] - m_new);
          const float pe = expf(s - m_new);
          l[r] = l[r] * corr + pe;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][e] = acc[r][e] * corr + pe * vv[e];
          m[r] = m_new;
        }
      }
    }
  }

  // merge the groups' states row by row (R is uniform over the block, so
  // the barriers inside the loop are reached by every thread)
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (r >= R) break;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc_s[grp][li * VEC + e] = acc[r][e];
    if (li == 0) {
      m_s[grp] = m[r];
      l_s[grp] = l[r];
    }
    __syncthreads();
    const size_t out_row = (size_t)b * R + r;
    for (int d = threadIdx.x; d < HD; d += NW * 32) {
      float mx = NEG;
      for (int gi = 0; gi < NG; ++gi) mx = fmaxf(mx, m_s[gi]);
      float lt = 0.f, a = 0.f;
      for (int gi = 0; gi < NG; ++gi) {
        const float w = expf(m_s[gi] - mx);
        lt += l_s[gi] * w;
        a += acc_s[gi][d] * w;
      }
      acc_o[out_row * D + h * HD + d] = a;
      if (d == 0) {
        m_o[out_row * H + h] = mx;
        l_o[out_row * H + h] = lt;
      }
    }
    __syncthreads();
  }
}

template <typename T, int HD, int NR>
void launch(const void* q, const void* kc, const void* vc, const int8_t* mask,
            const int* pos, float* acc, float* m, float* l, int pos_scalar, int mode,
            int B, int S, int H, int R, long long kv_stride, float scale,
            cudaStream_t st) {
  dim3 grid(H, B);
  beam_attend_kernel<T, HD, NR><<<grid, NW * 32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      mask, pos, acc, m, l, pos_scalar, mode, S, H, R, kv_stride, scale);
}

template <typename T, int HD>
int launch_rows(const void* q, const void* kc, const void* vc, const int8_t* mask,
                const int* pos, float* acc, float* m, float* l, int pos_scalar,
                int mode, int B, int S, int H, int R, long long kv_stride, float scale,
                cudaStream_t st) {
#define BEAM_LAUNCH(NR_)                                                          \
  launch<T, HD, NR_>(q, kc, vc, mask, pos, acc, m, l, pos_scalar, mode, B, S, H, \
                     R, kv_stride, scale, st)
  if (R <= 1) BEAM_LAUNCH(1);
  else if (R <= 2) BEAM_LAUNCH(2);
  else if (R <= 4) BEAM_LAUNCH(4);
  else if (R <= 8) BEAM_LAUNCH(8);
  else if (R <= 16) BEAM_LAUNCH(16);
  else return cudaErrorInvalidValue;
#undef BEAM_LAUNCH
  return cudaSuccess;
}

}  // namespace

// q: (B*R, H*hd); kc, vc: (B, S, H*hd) with rows dense and batch stride
// kv_stride (elements); mask: (B, R, S) int8/bool for mode 1, else unused;
// pos: (B,) int32 on the device for mode 2, or null to use pos_scalar.
// Outputs acc (B*R, H*hd), m and l (B*R, H), fp32.  dtype: 0 = float32,
// 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int beam_attend(const void* q, const void* kc, const void* vc,
                           const void* mask, const void* pos, void* acc, void* m,
                           void* l, int pos_scalar, int mode, int B, int S, int H,
                           int R, int hd, int dtype, long long kv_stride,
                           float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* mk = static_cast<const int8_t*>(mask);
  const int* p = static_cast<const int*>(pos);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  if (B < 1 || S < 1 || H < 1 || R < 1 || mode < 0 || mode > 2) return cudaErrorInvalidValue;
  if (mode == 1 && mk == nullptr) return cudaErrorInvalidValue;
  int err;
  if (dtype == 0 && hd == 64)
    err = launch_rows<float, 64>(q, kc, vc, mk, p, a, mm, ll, pos_scalar, mode, B, S, H, R, kv_stride, scale, st);
  else if (dtype == 0 && hd == 128)
    err = launch_rows<float, 128>(q, kc, vc, mk, p, a, mm, ll, pos_scalar, mode, B, S, H, R, kv_stride, scale, st);
  else if (dtype == 1 && hd == 64)
    err = launch_rows<__nv_bfloat16, 64>(q, kc, vc, mk, p, a, mm, ll, pos_scalar, mode, B, S, H, R, kv_stride, scale, st);
  else if (dtype == 1 && hd == 128)
    err = launch_rows<__nv_bfloat16, 128>(q, kc, vc, mk, p, a, mm, ll, pos_scalar, mode, B, S, H, R, kv_stride, scale, st);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}
