// In-place KV-cache append for Hopper (sm_90a), plain CUDA C++ behind a C ABI.
//
// Replaces: chainermn_tpu/ops/kv_cache.py :: _append_kernel (the
// pallas_call in cache_append).  Same function: write `rows` new K and V
// rows per batch row into the caches (B, S, W) at pos along the position
// axis, in place.  pos is one value for all rows or one per row, and the
// start is clamped to [0, S - rows] exactly as dynamic_update_slice clamps:
// a free serving slot's position drifts past the cache's end, and the clamp
// keeps its write inside its own row.
//
// Bound on this card: the function reads the new rows and writes them once,
// 2 x B x rows x W elements per tensor (32 KB for a bf16 tick at 8 slots x
// 1024 lanes), so it is bandwidth-bound and, at a tick's size, bound by the
// launch itself.  Design: K and V in one launch, 16-byte stores where the
// row width allows, one thread per 16 bytes; the caches outside the written
// rows are never touched.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename U>
__global__ void cache_append_kernel(U* __restrict__ kc, U* __restrict__ vc,
                                    const U* __restrict__ kn, const U* __restrict__ vn,
                                    const int* __restrict__ pos, int pos_scalar, int S,
                                    int rows, int units) {
  const int b = blockIdx.y;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)rows * units) return;
  const int r = static_cast<int>(idx / units);
  const int u = static_cast<int>(idx % units);
  int start = pos != nullptr ? pos[b] : pos_scalar;
  start = max(0, min(start, S - rows));
  const size_t dst = ((size_t)b * S + start + r) * units + u;
  const size_t src = ((size_t)b * rows + r) * units + u;
  kc[dst] = kn[src];
  vc[dst] = vn[src];
}

template <typename U>
void launch(void* kc, void* vc, const void* kn, const void* vn, const int* pos,
            int pos_scalar, int B, int S, int rows, int units, cudaStream_t st) {
  constexpr int NT = 256;
  const long long n = (long long)rows * units;
  dim3 grid(static_cast<unsigned>((n + NT - 1) / NT), B);
  cache_append_kernel<U><<<grid, NT, 0, st>>>(
      static_cast<U*>(kc), static_cast<U*>(vc), static_cast<const U*>(kn),
      static_cast<const U*>(vn), pos, pos_scalar, S, rows, units);
}

}  // namespace

// kc, vc: (B, S, W); kn, vn: (B, rows, W), all of one dtype with row_bytes =
// W * element size.  pos: (B,) int32 on the device, or null to use
// pos_scalar for every row.  Returns the launch's cudaError_t.
extern "C" int cache_append(void* kc, void* vc, const void* kn, const void* vn,
                            const void* pos, int pos_scalar, int B, int S, int rows,
                            int row_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (B < 1 || rows < 1 || rows > S || row_bytes < 1) return cudaErrorInvalidValue;
  if (row_bytes % 16 == 0)
    launch<uint4>(kc, vc, kn, vn, p, pos_scalar, B, S, rows, row_bytes / 16, st);
  else if (row_bytes % 4 == 0)
    launch<uint32_t>(kc, vc, kn, vn, p, pos_scalar, B, S, rows, row_bytes / 4, st);
  else if (row_bytes % 2 == 0)
    launch<uint16_t>(kc, vc, kn, vn, p, pos_scalar, B, S, rows, row_bytes / 2, st);
  else
    launch<uint8_t>(kc, vc, kn, vn, p, pos_scalar, B, S, rows, row_bytes, st);
  return static_cast<int>(cudaGetLastError());
}
