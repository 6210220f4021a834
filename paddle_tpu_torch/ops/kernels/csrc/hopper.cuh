// Hopper building blocks shared by the port's sm_90a kernels (flash
// attention K1/K2, fused_conv K4): shared-memory addresses, mbarriers, TMA
// loads and stores, the warpgroup matrix multiply (wgmma) and its operand
// descriptors, the accumulator fragment's layout, setmaxnreg, and the
// host-side lookup of cuTensorMapEncodeTiled. Inline PTX throughout; every
// name lives in an anonymous namespace, so each source that includes this
// gets its own copy.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWG = 128;                 // threads in a warpgroup

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}
// returns once the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}
// a contiguous run of bytes (16-byte aligned, a multiple of 16)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a 2-D box at (c0, c1) of `map` (c0 the contiguous dimension)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
// the reverse: shared memory to the box at (c0, c1); the box's part past the
// tensor's extent is not written. Committed as one bulk group per call of
// bulk_commit
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// returns once the committed bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// returns once the committed bulk stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// orders this thread's shared-memory writes before later TMA reads of them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// a barrier among `threads` threads (a multiple of 32) under id 1..15
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
// four 8 x 8 bf16 matrices from shared memory, one row address a lane (lanes
// 8i..8i+7 give matrix i's rows); register i holds matrix i's row lane/4,
// columns 2*(lane%4) and 2*(lane%4)+1
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// ---- warpgroup matrix multiply
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// pins registers in place around the asynchronous products: values written
// before are written before the fence that follows, reads after the wait
// read the products' results
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// shared-memory matrix descriptor of a tile of 128-byte rows under the
// 128-byte swizzle: 8-row groups 1024 bytes apart (stride byte offset); the
// leading byte offset is not read (one swizzle atom spans the instruction's
// K for K-major operands and its N for the m64n64 MN-major ones)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// the same for an MN-major operand wider than one swizzle atom: 64-column
// atoms `atom_bytes` apart (leading byte offset), 8-row groups along K 1024
// bytes apart (stride byte offset)
__device__ __forceinline__ uint64_t sw128_desc_mn(const void* p,
                                                  uint32_t atom_bytes) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(atom_bytes >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
constexpr bool kIsHalf = std::is_same<T, __half>::value;

// two f32 values rounded to nearest in T (bf16 or f16), lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsHalf<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

// ---- wgmma wrappers (16-bit inputs, f32 accumulators). T is the inputs'
// type: __nv_bfloat16 (the default) or __half. The two take the same operand
// fragments and descriptors; only the instruction's input type differs.
// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory
#define WGMMA_SS_N128(TY) \
  asm volatile(                                                          \
      "{\n.reg .pred p;\n"                                               \
      "setp.ne.b32 p, %66, 0;\n"                                         \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "       \
      "{"                                                                \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                           \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                         \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                         \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                         \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                         \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                         \
      "%56, %57, %58, %59, %60, %61, %62, %63"                           \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),      \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),      \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])               \
      : "l"(a), "l"(b), "r"(accumulate))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
  if constexpr (kIsHalf<T>)
    WGMMA_SS_N128("f16");
  else
    WGMMA_SS_N128("bf16");
}
#undef WGMMA_SS_N128

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
#define WGMMA_SS_N64(TY) \
  asm volatile(                                                          \
      "{\n.reg .pred p;\n"                                               \
      "setp.ne.b32 p, %34, 0;\n"                                         \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "        \
      "{"                                                                \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                           \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                         \
      "%24, %25, %26, %27, %28, %29, %30, %31"                           \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),      \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),      \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31])                                         \
      : "l"(a), "l"(b), "r"(accumulate))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  if constexpr (kIsHalf<T>)
    WGMMA_SS_N64("f16");
  else
    WGMMA_SS_N64("bf16");
}
#undef WGMMA_SS_N64

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (four 16-bit pairs
// per thread), B MN-major in shared memory
#define WGMMA_RS_N64(TY) \
  asm volatile(                                                          \
      "{\n.reg .pred p;\n"                                               \
      "setp.ne.b32 p, %37, 0;\n"                                         \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "        \
      "{"                                                                \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                           \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                         \
      "%24, %25, %26, %27, %28, %29, %30, %31"                           \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),      \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),      \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31])                                         \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b) {
  if constexpr (kIsHalf<T>)
    WGMMA_RS_N64("f16");
  else
    WGMMA_RS_N64("bf16");
}
#undef WGMMA_RS_N64

// d[64 x 128] += A[64 x 16] B[16 x 128], A in registers as for
// wgmma_rs_n64, B MN-major in shared memory: 2 swizzle atoms of 64
// columns, `b` from sw128_desc_mn
#define WGMMA_RS_N128(TY) \
  asm volatile(                                                          \
      "{\n.reg .pred p;\n"                                               \
      "setp.ne.b32 p, %69, 0;\n"                                         \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "       \
      "{"                                                                \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                           \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                         \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                         \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                         \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                         \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                         \
      "%56, %57, %58, %59, %60, %61, %62, %63"                           \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),      \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),      \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])               \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t b) {
  if constexpr (kIsHalf<T>)
    WGMMA_RS_N128("f16");
  else
    WGMMA_RS_N128("bf16");
}
#undef WGMMA_RS_N128

// d[64 x 256] += A[64 x 16] B[16 x 256], A in registers as for
// wgmma_rs_n64, B MN-major in shared memory: 4 swizzle atoms of 64
// columns, `b` from sw128_desc_mn
#define WGMMA_RS_N256(TY) \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %133, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "            \
      "{"                                                                     \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                              \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                              \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                              \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                              \
      "%56, %57, %58, %59, %60, %61, %62, %63, "                              \
      "%64, %65, %66, %67, %68, %69, %70, %71, "                              \
      "%72, %73, %74, %75, %76, %77, %78, %79, "                              \
      "%80, %81, %82, %83, %84, %85, %86, %87, "                              \
      "%88, %89, %90, %91, %92, %93, %94, %95, "                              \
      "%96, %97, %98, %99, %100, %101, %102, %103, "                          \
      "%104, %105, %106, %107, %108, %109, %110, %111, "                      \
      "%112, %113, %114, %115, %116, %117, %118, %119, "                      \
      "%120, %121, %122, %123, %124, %125, %126, %127"                        \
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),      \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),      \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),      \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),      \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),      \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),      \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),      \
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),      \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),      \
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),      \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),      \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),      \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),      \
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),      \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), \
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), \
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), \
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])                              \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t b) {
  if constexpr (kIsHalf<T>)
    WGMMA_RS_N256("f16");
  else
    WGMMA_RS_N256("bf16");
}
#undef WGMMA_RS_N256

// accumulator fragment of a warpgroup's m64nN product (N/2 floats a thread):
// entry i holds row 16*warp + lane/4 + 8*((i>>1)&1) and column
// 8*(i/4) + 2*(lane%4) + (i&1). Packed pairwise to bf16 (entries 2k, 2k+1
// in register k), registers 4kk..4kk+3 are exactly the A-operand fragment of
// a product over columns 16kk..16kk+15: P and dS go from one product's
// accumulator to the next product's A operand with no shuffle.
struct Frag {
  int lane, rl, cl;  // lane; the thread's first row (of 64); column offset
  __device__ __forceinline__ explicit Frag(int t)
      : lane(t % 32), rl(16 * (t / 32) + (t % 32) / 4), cl(2 * (t % 32 % 4)) {}
  static __device__ __forceinline__ int row(int i) {
    return 8 * ((i >> 1) & 1);
  }
  __device__ __forceinline__ int col(int i) const {
    return 8 * (i / 4) + cl + (i & 1);
  }
};

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

// ------------------------------------------------------------ host
// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
constexpr int kErrNoEncoder = -2;  // cuTensorMapEncodeTiled is unavailable
constexpr int kErrTensorMap = -3;  // it refused an operand's tensor map

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace
