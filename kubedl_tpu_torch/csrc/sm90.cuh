// Hopper (sm_90a) building blocks for the port's tensor-core kernels:
// mbarriers, TMA tile loads, wgmma descriptors and products, and the host
// side of TMA (tensor maps). Inline PTX only; no CUTLASS.
//
// Shared-memory tiles are written by TMA with the 128-byte swizzle: a box
// is 64 half-precision columns (128 bytes) by R rows, 16-byte chunks of
// row r permuted by r % 8. A head dim of 128 is two such boxes, one after
// the other. Every tile starts on a 1024-byte boundary (one swizzle
// period), so the descriptors' base-offset field stays 0.
//
// libcuda's cuTensorMapEncodeTiled is fetched at run time through the
// runtime's entry-point query rather than by linking -lcuda: the library
// then needs only the runtime that nvcc links by default, and the build
// needs no libcuda stub on its link path.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// a named barrier over n threads (id 0 is __syncthreads'): it also orders
// their shared-memory writes before it against their reads after it
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// --------------------------------------------------------------------- TMA

// a box of a rank-4 tensor map into shared memory; completion counts
// against `bar`. Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a box of shared memory into a rank-4 tensor map; elements outside the
// tensor are not written. Reads of shared memory complete in order with
// bulk_wait_read, writes to global memory with bulk_wait.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N committed stores still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
// until at most N committed stores are still incomplete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}
// order this thread's writes to shared memory before later async-proxy
// (TMA, wgmma) reads of it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence/commit/wait instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
  #pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
  #pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle. K-major operands
// (the reduction dim contiguous): SBO = 1024 (8 rows of 128 bytes), LBO
// unused; a 16-wide k step inside a box adds 32 bytes to the start. MN-
// major operands (tnsp): LBO = the distance between two 64-column boxes,
// SBO = 1024 between groups of 8 k rows.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16)
         | (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32)
         | (1ull << 62);
}

#define KUBEDL_D8(d, i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define KUBEDL_D32(d) KUBEDL_D8(d, 0), KUBEDL_D8(d, 8), KUBEDL_D8(d, 16),    \
                      KUBEDL_D8(d, 24)
#define KUBEDL_D64(d) KUBEDL_D32(d), KUBEDL_D8(d, 32), KUBEDL_D8(d, 40),     \
                      KUBEDL_D8(d, 48), KUBEDL_D8(d, 56)
#define KUBEDL_D32_AT(d, i) KUBEDL_D8(d, i), KUBEDL_D8(d, i + 8),             \
                            KUBEDL_D8(d, i + 16), KUBEDL_D8(d, i + 24)
#define KUBEDL_D128(d) KUBEDL_D64(d), KUBEDL_D32_AT(d, 64),                  \
                       KUBEDL_D32_AT(d, 96)
#define KUBEDL_R32                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define KUBEDL_R64                                                         \
  KUBEDL_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "   \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63"
#define KUBEDL_R128                                                        \
  KUBEDL_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, "   \
  "%75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, " \
  "%89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, "    \
  "%102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, "      \
  "%113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "     \
  "%124, %125, %126, %127"

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, both K-major in shared memory
#define KUBEDL_WGMMA_SS64(TY)                                              \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"              \
               " wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY    \
               " {" KUBEDL_R32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"          \
               : KUBEDL_D32(d) : "l"(a), "l"(b), "r"(acc))
template <bool F16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
  if constexpr (F16) KUBEDL_WGMMA_SS64("f16");
  else KUBEDL_WGMMA_SS64("bf16");
}

// d[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, both K-major in shared memory
#define KUBEDL_WGMMA_SS128(TY)                                             \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"              \
               " wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY   \
               " {" KUBEDL_R64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"          \
               : KUBEDL_D64(d) : "l"(a), "l"(b), "r"(acc))
template <bool F16>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int acc) {
  if constexpr (F16) KUBEDL_WGMMA_SS128("f16");
  else KUBEDL_WGMMA_SS128("bf16");
}

// d[64 x N] (+)= A[64 x 16] . B[16 x N]: A from registers (the fragment
// of a 64 x 16 slice of an accumulator), B MN-major in shared memory; N
// 256 spans four 64-column boxes, LBO apart
#define KUBEDL_WGMMA_RS64(TY)                                              \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"              \
               " wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY    \
               " {" KUBEDL_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;" \
               "\n}\n"                                                     \
               : KUBEDL_D32(d)                                             \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),       \
                 "r"(acc))
#define KUBEDL_WGMMA_RS128(TY)                                             \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"              \
               " wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY   \
               " {" KUBEDL_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;" \
               "\n}\n"                                                     \
               : KUBEDL_D64(d)                                             \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),       \
                 "r"(acc))
#define KUBEDL_WGMMA_RS256(TY)                                             \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"             \
               " wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY   \
               " {" KUBEDL_R128 "}, {%128, %129, %130, %131}, %132, p, "  \
               "1, 1, 1;\n}\n"                                             \
               : KUBEDL_D128(d)                                            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),       \
                 "r"(acc))
template <bool F16, int N>
__device__ __forceinline__ void wgmma_rs_tn(float (&d)[N / 2],
                                            const uint32_t* a, uint64_t b,
                                            int acc) {
  static_assert(N == 64 || N == 128 || N == 256,
                "wgmma_rs_tn: N is 64, 128 or 256");
  if constexpr (N == 64) {
    if constexpr (F16) KUBEDL_WGMMA_RS64("f16");
    else KUBEDL_WGMMA_RS64("bf16");
  } else if constexpr (N == 128) {
    if constexpr (F16) KUBEDL_WGMMA_RS128("f16");
    else KUBEDL_WGMMA_RS128("bf16");
  } else {
    if constexpr (F16) KUBEDL_WGMMA_RS256("f16");
    else KUBEDL_WGMMA_RS256("bf16");
  }
}

// 2^x on the special-function unit (2 ulp; results below 2^-126 flush to
// zero)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 values as one 32-bit register of the operand type, lo first
template <bool F16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (F16) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

// the two values of a pack2 register back in f32, lo first
template <bool F16>
__device__ __forceinline__ float2 unpack2(uint32_t r) {
  if constexpr (F16) {
    return __half22float2(*reinterpret_cast<__half2*>(&r));
  } else {
    return make_float2(__uint_as_float(r << 16),
                       __uint_as_float(r & 0xffff0000u));
  }
}

// ------------------------------------------------------------- host: TMA

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess
        && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a tiled map over a [b, s, h, d] half-precision tensor (element strides
// for b, s, h; d contiguous): boxes of 64 columns x `rows` rows of one
// (batch, head), 128-byte swizzle
inline bool map_bshd(CUtensorMap* map, const void* base, bool f16, int b,
                     int s, int h, int d, int64_t sb, int64_t ss, int64_t sh,
                     int rows) {
  EncodeTiled fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return fn(map, f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            4, const_cast<void*>(base), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
