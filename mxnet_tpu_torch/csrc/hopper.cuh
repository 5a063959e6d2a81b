// Device and host helpers shared by the port's Hopper (sm_90a) kernels:
// csrc/flash_attn_fwd_tc.cu and csrc/flash_attn_fwd_tf32x3.cu (K1),
// csrc/flash_attn_bwd_tc.cu and csrc/flash_attn_bwd_tf32x3.cu (K2) and
// csrc/conv3x3_bn_stats_tc.cu and csrc/conv3x3_bn_stats_tf32x3.cu (K3)
// and csrc/s8_gemm_wgmma.cu (K5) include it. It holds the mbarrier ring
// primitives, TMA loads (tiled, im2col and plain bulk), the descriptors of
// swizzled and unswizzled shared-memory tiles, the warpgroup products
// (wgmma) in 16-bit, TF32 and int8 with both operands in shared memory or A
// in registers, the 16-bit packing and hi + lo split of f32 values, the
// TF32 hi + lo split of f32 tiles in shared memory (3xTF32), and the host's
// tensor-map encoding (tiled and im2col).
//
// ops/_build.py hashes this file into the digest of every source that
// includes it, so editing it rebuilds them all. Everything here has
// internal linkage: each library keeps its own copy.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int PANEL = 64;               // 16-bit columns per swizzled row
constexpr int ROW_BYTES = 128;          // bytes per swizzled row
constexpr int ERR_NO_ENCODER = 1000;    // a tensor-map encoder is missing
constexpr int ERR_ENCODE = 1001;        // the driver refused a tensor map
constexpr int ERR_SHAPE = 1002;         // a shape the kernel does not take

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async (TMA) proxy.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the completion of the barrier's phase of this parity. A wait
// that outlasts any real load or tile by orders of magnitude traps, so a
// lost arrival fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  for (uint32_t n = 0; !mbar_try_wait(a, parity); ++n)
    if (n == (1u << 24)) __trap();
}

// Only the consumer warpgroups meet here (named barrier 1); the producer
// warp has left.
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// ------------------------------------------------------------------ TMA
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Fetches a tensor map (a __grid_constant__ parameter) ahead of its first
// load.
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// BM pixels x 64 channels of x, starting at the im2col position
// (w, h, n), shifted by the tap (kw, kh); out of the image reads as zero.
__device__ __forceinline__ void tma_load_im2col(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int c, int w,
                                                int h, int n, uint16_t kw,
                                                uint16_t kh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c),
      "r"(w), "r"(h), "r"(n), "h"(kw), "h"(kh)
      : "memory");
}

// `bytes` contiguous bytes from global to shared memory by the copy
// engine; both addresses 16-byte aligned, bytes a multiple of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
// K-major operands: SBO = 1024 (8 rows of 128 bytes), LBO unused.
// MN-major operands: SBO = 1024 (8 K-rows), LBO = the stride between
// panels of 64 N-columns.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

// The same for any layout type: 0 no swizzle (8-row x 16-byte core
// matrices; K-major: LBO the stride between the two core matrices of a
// 32-byte K step, SBO between 8-row groups), 1, 2, 3 the 128-, 64- and
// 32-byte swizzles (K-major: SBO = 8 rows, LBO unused).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(layout) << 62);
}

// 2^x by the special-function unit (relative error ~2^-22; 0 for -inf).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Ties registers that an in-flight wgmma reads or writes to this point of
// the instruction stream, so the compiler moves no access across it.
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x N, f32) = or += A (64 x 16) B (16 x N), both from shared
// memory: A K-major, B K-major (TRANS_B = 0) or MN-major (TRANS_B = 1).
// acc = 0 overwrites D. F16 picks fp16 inputs over bf16.
template <int N, bool F16, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int acc) {
  if constexpr (N == 32 && !F16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, %19;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(acc), "n"(TRANS_B));
  } else if constexpr (N == 32 && F16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, %19;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(acc), "n"(TRANS_B));
  } else if constexpr (N == 64 && !F16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc), "n"(TRANS_B));
  } else if constexpr (N == 64 && F16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc), "n"(TRANS_B));
  } else if constexpr (N == 128 && !F16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc), "n"(TRANS_B));
  } else if constexpr (N == 128 && F16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc), "n"(TRANS_B));
  } else {
    static_assert(N == 0, "wgmma_ss: no such shape");
  }
}

// D (64 x N, f32) += A (64 x 16) B (16 x N): A from registers (the 16-bit
// fragment of one k16 slice), B MN-major from shared memory.
template <int N, bool F16>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 64 && !F16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 64 && F16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 128 && !F16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 128 && F16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    static_assert(N == 0, "wgmma_rs: no such shape");
  }
}

// D (64 x N, f32) = or += A (64 x 8) B (8 x N) in TF32, both from shared
// memory, both K-major (TF32 has no transpose flags); acc = 0 overwrites D.
// Each 32-bit operand is read as TF32: callers pass values that
// cvt.rna.tf32.f32 produced (split_tf32).
template <int N>
__device__ __forceinline__ void wgmma_ss_tf32(float* d, uint64_t da,
                                              uint64_t db, int acc) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(acc));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(acc));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  } else {
    static_assert(N == 0, "wgmma_ss_tf32: no such shape");
  }
}

// D (64 x N, f32) = or += A (64 x 8) B (8 x N) in TF32: A from registers
// (4 x b32 a thread, see tf32_a_fragment below), B K-major from shared
// memory; acc = 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float* d, const uint32_t* a,
                                              uint64_t db, int acc = 1) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  } else {
    static_assert(N == 0, "wgmma_rs_tf32: no such shape");
  }
}

// D (64 x N, s32) += A (64 x 32) B (32 x N) in int8 (s8 x s8, exact), both
// from shared memory and both K-major: 8-bit wgmma has no transpose flags.
// The s32 fragment is laid out as the f32 one below.
template <int N>
__device__ __forceinline__ void wgmma_s8(uint32_t* d, uint64_t da,
                                         uint64_t db) {
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
  } else {
    static_assert(N == 0, "wgmma_s8: no such shape");
  }
}

// Accumulator fragment of wgmma m64nN f32, for the thread at lane
// (g = lane / 4, c = lane % 4) of warp w in its warpgroup: register
// 4j + e holds row 16w + g + 8 (e / 2), column 8j + 2c + e % 2. The
// 16-bit A fragment of the k16 slice kk is, in the same thread, registers
// {8kk + 2r, 8kk + 2r + 1} for r = 0..3: so a product's f32 result
// becomes the A operand of the next product without leaving registers.

// ------------------------------------------------------- 16-bit packing
template <typename T> __device__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t
pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo,
                                                             float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) = hi + lo, each a pair of 16-bit values packed low half first,
// so that ~16 bits of each value survive a product. For bf16, hi keeps the
// top 16 bits of each f32 (a bit mask, no conversion) and lo is the rest,
// rounded.
template <typename T>
__device__ void split2(float a, float b, uint32_t& hi, uint32_t& lo);
template <> __device__ __forceinline__ void split2<__nv_bfloat16>(
    float a, float b, uint32_t& hi, uint32_t& lo) {
  const uint32_t ua = __float_as_uint(a) & 0xFFFF0000u;
  const uint32_t ub = __float_as_uint(b) & 0xFFFF0000u;
  hi = __byte_perm(ua, ub, 0x7632);
  lo = pack2<__nv_bfloat16>(a - __uint_as_float(ua), b - __uint_as_float(ub));
}
template <> __device__ __forceinline__ void split2<__half>(
    float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack2<__half>(a, b);
  const float2 h = __half22float2(*reinterpret_cast<__half2*>(&hi));
  lo = pack2<__half>(a - h.x, b - h.y);
}

// ----------------------------------------------------------------- TF32
// fp32 products on the tensor cores as 3xTF32: each f32 operand x is split
// into hi = rna_tf32(x) and lo = rna_tf32(x - hi) (x - hi is exact in
// f32), and a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b with f32
// accumulation. Only lo_a lo_b (~2^-22 of |a b|) is dropped. A TF32 row of
// a 128-byte-swizzled tile holds PANEL32 values; a k8 step is 32 bytes, as
// a bf16 k16 step is, so sw128_desc serves both.
constexpr int PANEL32 = 32;             // f32 columns per swizzled row

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Makes this thread's shared-memory stores visible to the async proxy
// (wgmma, TMA); a barrier among the threads must follow before the read.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Byte offset of f32 element (row, col) in a 128-byte-swizzled panel
// (col < 32) whose base is 1024-byte aligned.
__device__ __forceinline__ int sw128(int row, int col) {
  return row * ROW_BYTES + ((((col >> 2) ^ row) & 7) << 4) + (col & 3) * 4;
}

// TF32 A fragment of wgmma m64k8: the thread at lane (g, c) holds
// (row g, col c), (g + 8, c), (g, c + 4), (g + 8, c + 4) of its warp's 16
// rows. An f32 accumulator fragment holds columns 2c and 2c + 1 of each
// 8-column group instead (see below), so a product's result becomes the
// next product's A operand when the reduction index j of each k8 step is
// stored at column frag_col(j) of the B tile: j = 2c goes to c, j = 2c + 1
// to c + 4. The A registers of step kk are then accumulator registers
// 4kk + {0, 2, 1, 3}.
__device__ __forceinline__ int frag_col(int j) {
  return (j & ~7) | ((j & 7) >> 1) | ((j & 1) << 2);
}

template <int N>
__device__ __forceinline__ void tf32_a_fragment(const float* acc,
                                                uint32_t (*hi)[4],
                                                uint32_t (*lo)[4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    split_tf32(acc[4 * kk + 0], hi[kk][0], lo[kk][0]);
    split_tf32(acc[4 * kk + 2], hi[kk][1], lo[kk][1]);
    split_tf32(acc[4 * kk + 1], hi[kk][2], lo[kk][2]);
    split_tf32(acc[4 * kk + 3], hi[kk][3], lo[kk][3]);
  }
}

// A tile of `bytes` f32 (any layout) split in place into its hi part, the
// lo part at the same offsets from `lo`; thread tid of n, 16 bytes a step.
__device__ __forceinline__ void split_tile(uint8_t* src, uint8_t* lo,
                                           int bytes, int tid, int n) {
  for (int i = tid * 16; i < bytes; i += n * 16) {
    const float4 x = *reinterpret_cast<const float4*>(src + i);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(src + i) = h;
    *reinterpret_cast<uint4*>(lo + i) = l;
  }
}

// A TMA-loaded tile of R rows by D f32 columns (D / 32 swizzled panels of
// R rows, one after the other) written transposed into `dst`: D rows by
// 2R columns in panels of 32 columns (D rows each), hi of row r at column
// frag_col(r), lo at R + frag_col(r), so that the tile is the K-major B
// operand of a product that reduces over the R rows, hi and lo alike.
// With NATURAL the source is also split in place (hi) with lo at the same
// offsets from `lo`, by the thread that reads it. A warp's 32 threads take
// 32 rows of one 4-column chunk: every access is free of bank conflicts.
template <int R, int D, bool NATURAL>
__device__ __forceinline__ void split_tile_t(uint8_t* src, uint8_t* lo,
                                             uint8_t* dst, int tid, int n) {
  constexpr int PANEL_BYTES = D * ROW_BYTES;
  for (int i = tid; i < R * D / 4; i += n) {
    const int r = i % R, x0 = (i / R) * 4;
    const int at = (x0 / PANEL32) * R * ROW_BYTES + sw128(r, x0 % PANEL32);
    const float4 v = *reinterpret_cast<const float4*>(src + at);
    const float e[4] = {v.x, v.y, v.z, v.w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) split_tf32(e[k], h[k], l[k]);
    if constexpr (NATURAL) {
      *reinterpret_cast<uint4*>(src + at) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    const int yh = frag_col(r), yl = R + yh;
    uint8_t* ph = dst + (yh / PANEL32) * PANEL_BYTES;
    uint8_t* pl = dst + (yl / PANEL32) * PANEL_BYTES;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      *reinterpret_cast<uint32_t*>(ph + sw128(x0 + k, yh % PANEL32)) = h[k];
      *reinterpret_cast<uint32_t*>(pl + sw128(x0 + k, yl % PANEL32)) = l[k];
    }
  }
}

// Descriptor of k8 step kk of such a transposed tile (R reduction rows):
// its hi part, or with `lo` its lo part.
template <int R, int D>
__device__ __forceinline__ uint64_t t_desc(const uint8_t* dst, int kk,
                                           bool lo) {
  const int y = (lo ? R : 0) + 8 * kk;
  return sw128_desc(dst + (y / PANEL32) * D * ROW_BYTES + (y % PANEL32) * 4,
                    16, 1024);
}

// The 4-D tensor-map coordinates (c1, c2, c3) of row t, head h, batch b:
// pos packs the map position (1..3) of T, H and B in 2 bits each (see
// make_map).
__device__ __forceinline__ void coords(int pos, int t, int h, int b, int& c1,
                                       int& c2, int& c3) {
  const int pt = pos & 3, ph = (pos >> 2) & 3;
  c1 = pt == 1 ? t : ph == 1 ? h : b;
  c2 = pt == 2 ? t : ph == 2 ? h : b;
  c3 = pt == 3 ? t : ph == 3 ? h : b;
}

// ----------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// A driver entry point reached through the runtime, so the library needs
// no -lcuda; nullptr if the driver lacks it.
inline void* driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(name, &p, 12000,
                                                     cudaEnableDefault,
                                                     &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault,
                                            &found);
#endif
  return (err == cudaSuccess && found == cudaDriverEntryPointSuccess) ? p
                                                                      : nullptr;
}

// A 4-D map (D, then T, H, B in the order of increasing stride) over a
// tensor of `elem`-byte elements of `type` with element strides st, sh,
// sb; boxes of 128 bytes of D by `rows` rows of T, 128-byte swizzled, rows
// past T zero-filled. *pos receives the map positions of T, H and B (see
// coords).
inline int encode_map(CUtensorMap* map, const void* ptr,
                      CUtensorMapDataType type, int elem, int d, int t, int h,
                      int b, long long st, long long sh, long long sb,
                      int rows, int* pos) {
  static const EncodeTiled enc =
      reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
  if (!enc) return ERR_NO_ENCODER;
  long long size[3] = {t, h, b}, stride[3] = {st, sh, sb};
  int order[3] = {0, 1, 2};   // which of (T, H, B) sits at map dim 1, 2, 3
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (stride[order[j]] < stride[order[i]]) {
        const int x = order[i];
        order[i] = order[j];
        order[j] = x;
      }
  cuuint64_t gdim[4] = {cuuint64_t(d)};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {cuuint32_t(ROW_BYTES / elem)};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  *pos = 0;
  for (int i = 0; i < 3; ++i) {
    const int which = order[i];
    gdim[i + 1] = cuuint64_t(size[which]);
    gstride[i] = cuuint64_t(stride[which]) * elem;
    box[i + 1] = which == 0 ? cuuint32_t(rows) : 1;
    *pos |= (i + 1) << (2 * which);
  }
  CUresult r = enc(map, type, 4, const_cast<void*>(ptr), gdim, gstride, box,
                   estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

// encode_map over bf16 (or, with f16, fp16) elements: boxes of 64 columns.
inline int make_map(CUtensorMap* map, const void* ptr, bool f16, int d,
                    int t, int h, int b, long long st, long long sh,
                    long long sb, int rows, int* pos) {
  return encode_map(map, ptr,
                    f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    2, d, t, h, b, st, sh, sb, rows, pos);
}

// encode_map over f32 elements: boxes of PANEL32 columns.
inline int make_map_f32(CUtensorMap* map, const void* ptr, int d, int t,
                        int h, int b, long long st, long long sh,
                        long long sb, int rows, int* pos) {
  return encode_map(map, ptr, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, d, t, h, b,
                    st, sh, sb, rows, pos);
}

// A 2-D tiled map over `outer` rows of `inner` elements of `type`
// (`elem` bytes), rows `row_bytes` apart: boxes of box_inner x box_outer,
// swizzled by `swizzle` (its span must hold a box row); what falls outside
// reads as zero. K5 reads int8 operands through it, K-major.
inline int make_tiled_2d(CUtensorMap* map, const void* ptr,
                         CUtensorMapDataType type, long long inner,
                         long long outer, long long row_bytes, int box_inner,
                         int box_outer, CUtensorMapSwizzle swizzle) {
  static const EncodeTiled enc =
      reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
  if (!enc) return ERR_NO_ENCODER;
  const cuuint64_t dim[2] = {cuuint64_t(inner), cuuint64_t(outer)};
  const cuuint64_t stride[1] = {cuuint64_t(row_bytes)};
  const cuuint32_t box[2] = {cuuint32_t(box_inner), cuuint32_t(box_outer)};
  const cuuint32_t estride[2] = {1, 1};
  CUresult r = enc(map, type, 2, const_cast<void*>(ptr), dim, stride, box,
                   estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const int*, const int*,
                                 cuuint32_t, cuuint32_t, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The im2col map of a convolution over a dense NHWC tensor x (n, h, w, c)
// of `elem`-byte elements of `type` (TMA's dims C, W, H, N). One load
// brings `pixels` rows of `channels` elements (swizzled by `swizzle`): the
// output pixels in order, row after row and image after image, each as the
// input pixel of tap (0, 0), from the box's lower corner (lower_w, lower_h)
// to (w - 1 + upper_w, h - 1 + upper_h) in steps of the conv's strides
// (stride_w, stride_h); the load's offsets (the tap times the dilation)
// shift every pixel, and what falls outside x reads as zero. For pad p,
// kernel k and dilation d on an axis: lower = -p, upper = p - (k - 1) d.
// Corners lie in [-128, 127], strides in [1, 8] (the driver refuses the
// rest). K3 and K5 encode every im2col map here.
inline int make_im2col_map(CUtensorMap* map, const void* x,
                           CUtensorMapDataType type, int elem, int n, int h,
                           int w, int c, int lower_w, int lower_h,
                           int upper_w, int upper_h, int stride_w,
                           int stride_h, int channels, int pixels,
                           CUtensorMapSwizzle swizzle) {
  static const EncodeIm2col enc =
      reinterpret_cast<EncodeIm2col>(driver_entry("cuTensorMapEncodeIm2col"));
  if (!enc) return ERR_NO_ENCODER;
  const cuuint64_t dim[4] = {cuuint64_t(c), cuuint64_t(w), cuuint64_t(h),
                             cuuint64_t(n)};
  const cuuint64_t stride[3] = {cuuint64_t(c) * elem,
                                cuuint64_t(w) * c * elem,
                                cuuint64_t(h) * w * c * elem};
  const int lower[2] = {lower_w, lower_h}, upper[2] = {upper_w, upper_h};
  const cuuint32_t estride[4] = {1, cuuint32_t(stride_w),
                                 cuuint32_t(stride_h), 1};
  CUresult r = enc(map, type, 4, const_cast<void*>(x), dim, stride, lower,
                   upper, cuuint32_t(channels), cuuint32_t(pixels), estride,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

// Raises `kernel`'s dynamic shared memory limit to `bytes` once per device
// (`done` holds one bit per device). Returns 0 or a cudaError_t.
template <typename Kernel>
int allow_smem(Kernel* kernel, int bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev < 64 && ((done >> dev) & 1)) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) return int(e);
  if (dev < 64) done |= 1ull << dev;
  return 0;
}

}  // namespace
