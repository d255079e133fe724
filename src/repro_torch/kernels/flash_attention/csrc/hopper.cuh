// Hopper building blocks shared by the flash-attention kernels
// (flash_attention_tc.cuh, bf16; flash_attention_tf32.cuh, f32 as 3xTF32):
// mbarriers, TMA tile loads, wgmma descriptors and fences, and the host's
// tensor-map encoder, reached through the runtime (no -lcuda).
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the phase of parity `parity` has completed.  A wait that
// lasts some 10 s of clock traps (the launch then fails and the wrapper
// raises) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1LL << 34)) asm volatile("trap;");
  } while (!done);
}

// ---- TMA: a 4-D box into shared memory, completing on `bar` ----
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// ---- wgmma ----
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16 B units) and the swizzle layout type.  K-major operands (Q,
// K): the stride offset is the step between 8-row groups (8 rows of SW
// bytes), the leading offset unused under swizzle.  V as MN-major B: the
// stride offset is the step between groups of 8 keys, the leading offset
// the step between column chunks.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | static_cast<uint64_t>(layout) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of a register that an
// async wgmma owns across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// ---- host: tensor maps ----

// cuTensorMapEncodeTiled, from the CUDA driver through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    return err == cudaSuccess && res == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// Errors of this path that are not a cudaError_t: returned as negative
// codes, spelled out by error_string.
constexpr int kNoEncoder = -1;   // the CUDA driver has no cuTensorMapEncodeTiled
constexpr int kEncodeFailed = -1000;    // - CUresult of a failed encode

// A 4-D tiled map over `x` (dims and byte strides innermost first, the
// innermost stride implicit), boxes of `box`, swizzled `sw`; coordinates
// past a dim load as zeros.  0, or a negative code as above.
inline int encode_4d(CUtensorMap* map, CUtensorMapDataType type, const void* x,
                     const cuuint64_t (&dims)[4], const cuuint64_t (&strides)[3],
                     const cuuint32_t (&box)[4], CUtensorMapSwizzle sw) {
  EncodeTiled fn = encoder();
  if (!fn) return kNoEncoder;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, 4, const_cast<void*>(x), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed - static_cast<int>(r);
}

// The swizzle of a row of `bytes` bytes (128, 64 or 32) and its wgmma
// layout type.
inline CUtensorMapSwizzle swizzle_of(int bytes) {
  return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
}
constexpr int layout_of(int bytes) {
  return bytes == 128 ? 1 : bytes == 64 ? 2 : 3;
}

}  // namespace hopper
