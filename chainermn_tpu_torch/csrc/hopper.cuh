// Hopper (sm_90a) plumbing shared by the TMA + wgmma kernels of this
// package: mbarriers, TMA tensor loads, wgmma shared-memory descriptors and
// instructions, and the host-side tensor-map encoder.  Header-only; each
// including source compiles it into its own library.
//
// wgmma operand layouts used here (bf16, 128-byte swizzle, tiles written by
// TMA with CU_TENSOR_MAP_SWIZZLE_128B into 1024-byte-aligned shared memory):
//
//   K-major (a row of 64 k-values is one 128-byte line): 8-row groups 1024
//   bytes apart (SBO); LBO unused; a 16-deep k step moves the start by 32
//   bytes; the next 64 k-values are the next box (the caller's offset).
//
//   M/N-major (a line holds 64 M or N values of one k): k-rows 128 bytes
//   apart, 8 k-rows 1024 bytes apart (SBO); the next 64 M/N values are one
//   panel further on (LBO: the panel stride, e.g. 8 KB for 64-row boxes);
//   a 16-deep k step moves the start by 16 lines, 2 KB.
//
// The accumulator of m64nNk16 (fp32, N/2 registers a thread): element
// 4j + q sits at row 16 * warp + lane / 4 (+8 for q >= 2) of the warpgroup's
// 64, column 8j + 2 * (lane % 4) (+1 for odd q).  The A fragment of the
// register form for k-values 16kk .. 16kk + 15 is the same layout: the
// accumulator elements 8kk .. 8kk + 7 of a 64 x N product, packed in pairs.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// After every mbar_init of the block, before any thread uses a barrier.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Makes generic-proxy writes to shared memory visible to TMA and wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// `bytes` contiguous bytes of global memory at src into shared memory at dst
// (both 16-byte aligned, bytes a multiple of 16), completing on `bar`: a 1-D
// bulk copy, no tensor map.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One box of a 2-D `map` at (c0 inner, c1 outer) into shared memory at dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// One box of a 3-D `map` at (c0 innermost .. c2 outermost).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box of a 4-D `map` at (c0 innermost .. c3 outermost); coordinates may
// be negative or past the end: those elements arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor with 128-byte swizzle (see the top).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two fp32 values as one bf16x2 register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// The four threads of a quad each hold, for four 8-column groups jj, the
// bf16 pair at columns 2q, 2q + 1 of group jj (p[jj]).  Afterwards thread q
// holds all 8 columns of group q (p[0..3], columns 0-1, 2-3, 4-5, 6-7): one
// 16-byte store in place of four 4-byte ones.
__device__ __forceinline__ void quad_transpose(uint32_t (&p)[4]) {
  const int q = threadIdx.x & 3;
  // swap the off-diagonal 2 x 2 blocks with the thread two lanes away
  const bool hi = q & 2;
  uint32_t s0 = hi ? p[0] : p[2], s1 = hi ? p[1] : p[3];
  s0 = __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 = __shfl_xor_sync(0xffffffffu, s1, 2);
  if (hi) { p[0] = s0; p[1] = s1; } else { p[2] = s0; p[3] = s1; }
  // transpose each 2 x 2 block with the neighbouring lane
  const bool odd = q & 1;
  s0 = odd ? p[0] : p[1];
  s1 = odd ? p[2] : p[3];
  s0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  s1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  if (odd) { p[0] = s0; p[2] = s1; } else { p[1] = s0; p[3] = s1; }
}

#define ACC8(o)                                                                        \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),         \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define ACC32(o) ACC8(o), ACC8(o + 8), ACC8(o + 16), ACC8(o + 24)

// With accumulate 0 the product overwrites d.  TA / TB: the transpose bits
// (1 = M/N-major operand in shared memory).

// d (64 x 64 per warpgroup, fp32) {=, +=} A (64 x 16, shared) * B (16 x 64)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate = 1) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n\t}"
      : ACC32(0)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (64 x 64 per warpgroup, fp32) {=, +=} A (64 x 16, registers) * B (16 x 64)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate = 1) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n\t}"
      : ACC32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// d (64 x 128 per warpgroup, fp32) {=, +=} A (64 x 16, shared) * B (16 x 128)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate = 1) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n\t}"
      : ACC32(0), ACC32(32)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (64 x 128 per warpgroup, fp32) {=, +=} A (64 x 16, registers) * B (16 x 128)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate = 1) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n\t}"
      : ACC32(0), ACC32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// d (64 x 256 per warpgroup, fp32) {=, +=} A (64 x 16, shared) * B (16 x 256)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da, uint64_t db,
                                         int accumulate = 1) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n\t}"
      : ACC32(0), ACC32(32), ACC32(64), ACC32(96)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

#undef ACC32
#undef ACC8

// ---------------------------------------------------------------------------
// host side: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the runtime, so that a library
// links the runtime alone.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor of `rank` dims of `type` (dims[0] innermost and contiguous;
// strides in bytes of dims 1 .., each a multiple of 16), boxes of `box`
// elements, zeros outside.  With 128-byte swizzle a box row is at most 128
// bytes; without swizzle, box rows land densely in shared memory.  0, or the
// negated CUresult (cudaErrorNotSupported where the encoder is not found).
inline int make_map(CUtensorMap* map, CUtensorMapDataType type, CUtensorMapSwizzle swizzle,
                    const void* ptr, int rank, const cuuint64_t* dims,
                    const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = enc(map, type, rank, const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

// A bf16 tensor with 128-byte swizzle (box[0] at most 64), as the wgmma
// operands want it.
inline int make_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                    const cuuint64_t* strides, const cuuint32_t* box) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_SWIZZLE_128B, ptr, rank,
                  dims, strides, box);
}

// A row-major bf16 (rows, cols) matrix, boxes of box_rows x box_cols.
inline int make_map_2d(CUtensorMap* map, const void* ptr, int cols, int rows, int box_cols,
                       int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  return make_map(map, ptr, 2, dims, strides, box);
}

// A contiguous bf16 (d3, d2, d1, d0) array, d0 innermost, as a 4-D map.
inline int make_map_4d(CUtensorMap* map, const void* ptr, int d0, int d1, int d2, int d3,
                       int b0, int b1, int b2, int b3) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2), static_cast<cuuint64_t>(d3)};
  const cuuint64_t s1 = static_cast<cuuint64_t>(d0) * 2;
  const cuuint64_t strides[3] = {s1, s1 * d1, s1 * d1 * d2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(b0), static_cast<cuuint32_t>(b1),
                             static_cast<cuuint32_t>(b2), static_cast<cuuint32_t>(b3)};
  return make_map(map, ptr, 4, dims, strides, box);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace hopper
