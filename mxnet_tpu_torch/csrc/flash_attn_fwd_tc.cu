// Flash-attention forward on Hopper's tensor cores (sm_90a): kernel K1,
// tensor-core route.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py:_mha_kernel
// (:47), built by _build_flash (:119, the pl.pallas_call at :149) and
// entered through flash_attention (:173). It computes the same function as
// flash_attn_fwd.cu, the CUDA-core route, which stays for fp32 and for
// what this kernel does not take: for q, k, v (B, H, T, D) of one 16-bit
// dtype,
//   s   = scale * (q k^T)              (scaled in f32, after the product)
//   s   = -inf where causal and q_offset + i < k_offset + j, or j >= T
//   O   = softmax(s) v                 (rounded to the input dtype)
//   lse = m + log(max(l, 1e-20))       (f32, m = row max, l = row sum)
// A row with no visible key gives O = 0 and lse = -1e30 + log(1e-20).
//
// Takes: bf16 and fp16; D in {64, 128}; q, k, v whose last dimension has
// stride 1, whose other strides are multiples of 8 elements and whose base
// addresses are 16-byte aligned (ops/kernels.py:_flash_route). So the
// LM's q/k/v are read in place as strided views of the qkv projection's
// output. O is written into (B, T, H, D) memory, so the heads merge for
// free; lse into contiguous f32 (B, H, T).
//
// Bound on the H100 SXM at the LM's shape (8, 12, 1024, 64) bf16 causal:
// 1.29e10 FLOP is 13 us at 989 TFLOP/s; q, k, v read once, O and lse
// written once are 50.7 MB, 15 us at 3.35 TB/s. So bytes bound it.
//
// Design.
// - One CTA of 288 threads owns BQ = 128 query rows of one (batch, head):
//   two consumer warpgroups of 64 rows each and one producer warp. The
//   grid is (B * H, ceil(T / BQ)); blockIdx.y = 0 takes the last Q tile,
//   so under causal masking the heaviest tiles are dispatched first.
// - Q, K and V arrive by TMA, one 4-D tensor map each (D, T, H, B in the
//   order of increasing stride) built on the host from the tensors' own
//   strides, into 128-byte-swizzled tiles: one panel of 64 columns (128
//   bytes a row) per 64 of D. K/V go through a ring of STAGES = 3 stages
//   guarded by full/empty mbarriers, so the next tiles' loads overlap
//   this tile's math. TMA zero-fills rows past T; those columns are masked.
// - S = Q K^T is wgmma m64nBKk16 with both operands in shared memory (K's
//   [BK][D] tile is K-major for the B operand), accumulated in f32.
// - The online softmax runs on the f32 accumulator fragment in log2
//   units (scale * log2(e) applied to the f32 scores, exp2); row max and
//   row sum reduce over the fragment's quad with two xor shuffles.
// - O += P V is wgmma with A = P from registers: the f32 S fragment maps
//   onto the 16-bit A-operand fragment pair by pair. P is split into
//   hi + lo in the input dtype (for bf16, hi is the top 16 bits of each
//   f32 by a bit mask), and both go through the product, so ~16 bits of
//   each probability survive: P rounded once put O 9 output ulps off where
//   |O| is small, the split keeps it within 1 ulp for 1.5x the
//   tensor-core work and 13 % more time. l is summed from the unrounded
//   p. V's [BK][D] tile is MN-major for this product (transpose flag
//   set), so V is never transposed in memory.
// - Causal: K tiles wholly in the future of the CTA's rows are never
//   loaded, a warpgroup skips the math of a tile wholly in its rows'
//   future, and only tiles that cross the diagonal (or T) are masked.
// - Epilogue: O = acc / max(l, 1e-20) stored from registers with a bounds
//   check on the row; lse by one thread of each quad.
//
// Tiles: BQ = 128, BK = 64. Shared memory: Q 16 KB + 3 x (K 8 KB + V
// 8 KB) = 64 KB for D = 64, two CTAs per SM, which leaves 96 registers a
// thread; Q 32 KB + 3 x (16 + 16) KB = 128 KB for D = 128, one CTA per
// SM. ptxas: 96 registers for D = 64 and 163-167 for D = 128, no spills
// (chip_smoke.py phase a prints and checks it).
//
// What holds it back (tools/torch_k1_variants.py times the variants on
// the H100): each warpgroup runs Q K^T, waits, runs the softmax, runs
// P.V, waits, so its products and its softmax never overlap; the four
// warpgroups of an SM overlap each other only as far as their phases
// drift apart. Leaving out all P.V products saves under a fifth of the
// time. Tiles of 128 keys (one CTA per SM, 167 registers) are slower; so
// were, in probes not kept, a persistent kernel with QK(i+1) issued
// before the softmax of tile i (one CTA per SM) and turns taken between
// the two warpgroups on named barriers (spills at 96 registers). The
// next step is warpgroups with setmaxnreg-raised register budgets, so
// that the overlap fits without giving up warps per SM.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 128;                 // query rows per CTA
constexpr int CONSUMERS = 2;            // consumer warpgroups, 64 rows each
constexpr int NT = CONSUMERS * 128 + 32;  // + one producer warp
constexpr int STAGES = 3;               // K/V ring depth
constexpr int PANEL = 64;               // 16-bit columns per swizzled row
constexpr int ROW_BYTES = 128;          // bytes per swizzled row
constexpr float NEG = -1e30f;           // the TPU kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int MAX_Q_TILES = 65535;      // gridDim.y
constexpr int ERR_NO_ENCODER = 1000;    // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 1001;        // it refused a tensor map
constexpr int ERR_SHAPE = 1002;         // a shape the kernel does not take

template <int D> struct Tiles;
// BK: key rows per K/V tile. MIN_BLOCKS: CTAs per SM that the register
// budget must allow; two CTAs of 9 warps leave 96 registers a thread.
template <> struct Tiles<64> {
  static constexpr int BK = 64, MIN_BLOCKS = 2;
};
template <> struct Tiles<128> {
  static constexpr int BK = 64, MIN_BLOCKS = 1;
};

template <int D>
constexpr int smem_bytes() {
  // Q, then the K stages, then the V stages, then 2 * STAGES + 1 mbarriers;
  // plus 1 KB to align the tiles to the 1024-byte swizzle atom
  return BQ * D * 2 + 2 * STAGES * Tiles<D>::BK * D * 2 +
         (2 * STAGES + 1) * 8 + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
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

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
// K-major operands (Q, K): SBO = 1024 (8 rows of 128 bytes), LBO unused.
// The MN-major V: SBO = 1024 (8 K-rows), LBO = the stride between panels
// of 64 N-columns.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

// 2^x by the special-function unit (relative error ~2^-22; 0 for -inf).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Ties registers that an in-flight wgmma reads or writes to this point of
// the instruction stream, so the compiler moves no access across it.
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x N, f32) = or += A (64 x 16) B (16 x N): SS takes A and B from
// shared memory, both K-major; RS takes A from registers (the 16-bit
// fragment of one k16 slice) and B from shared memory, MN-major. acc = 0
// overwrites D. F16 picks fp16 inputs over bf16.
template <int N, bool F16>
__device__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int acc);
template <int N, bool F16>
__device__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db);

template <> __device__ __forceinline__ void
wgmma_ss<64, false>(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}
template <> __device__ __forceinline__ void
wgmma_rs<64, false>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void
wgmma_ss<128, false>(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}
template <> __device__ __forceinline__ void
wgmma_rs<128, false>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void
wgmma_ss<64, true>(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}
template <> __device__ __forceinline__ void
wgmma_rs<64, true>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void
wgmma_ss<128, true>(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}
template <> __device__ __forceinline__ void
wgmma_rs<128, true>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

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
// so that ~16 bits of each value survive. For bf16, hi keeps the top 16
// bits of each f32 (a bit mask, no conversion) and lo is the rest,
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

// The tensor-map coordinates (c1, c2, c3) of row t, head h, batch b: pos
// packs the map position (1..3) of T, H and B in 2 bits each.
__device__ __forceinline__ void coords(int pos, int t, int h, int b, int& c1,
                                       int& c2, int& c3) {
  const int pt = pos & 3, ph = (pos >> 2) & 3;
  c1 = pt == 1 ? t : ph == 1 ? h : b;
  c2 = pt == 2 ? t : ph == 2 ? h : b;
  c3 = pt == 3 ? t : ph == 3 ? h : b;
}

// Accumulator fragment of wgmma m64nN f32, for the thread at lane
// (g = lane / 4, c = lane % 4) of warp w in its warpgroup: register
// 4j + e holds row 16w + g + 8 (e / 2), column 8j + 2c + e % 2. The
// 16-bit A fragment of the k16 slice kk is, in the same thread, registers
// {8kk + 2r, 8kk + 2r + 1} for r = 0..3, which is how P is packed.
template <typename scalar_t, int D>
__global__ void __launch_bounds__(NT, Tiles<D>::MIN_BLOCKS)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    scalar_t* __restrict__ o, float* __restrict__ lse,
                    int n_heads, int t_len, float scale_log2, int causal,
                    int q_offset, int k_offset, int qpos, int kpos,
                    int vpos) {
  constexpr int BK = Tiles<D>::BK;
  constexpr int NP = D / PANEL;                    // 64-column panels
  constexpr int Q_PANEL = BQ * ROW_BYTES;
  constexpr int KV_PANEL = BK * ROW_BYTES;
  constexpr int KV_BYTES = NP * KV_PANEL;
  constexpr bool F16 = std::is_same<scalar_t, __half>::value;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sk = sq + NP * Q_PANEL;
  uint8_t* sv = sk + STAGES * KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sv + STAGES * KV_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first

  // Key j is visible to query row i when i + shift >= j. Rows and keys
  // are below 2^23 (at most 65535 Q tiles), so clamping the offsets'
  // difference to +-2^25 changes no comparison and keeps them in int.
  const int shift = int(max(-(1LL << 25), min(1LL << 25, (long long)q_offset -
                                                             k_offset)));
  // K tiles to visit: all, or under causal masking those holding a key
  // visible to some row of this Q tile.
  int n_kb = (t_len + BK - 1) / BK;
  if (causal) {
    const int last_key = q0 + min(BQ, t_len - q0) - 1 + shift;
    if (last_key < 0)
      n_kb = 0;
    else if (last_key / BK + 1 < n_kb)
      n_kb = last_key / BK + 1;
  }

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);   // one arrival per warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == CONSUMERS * 4) {
    // ---- producer: one thread keeps the TMA loads in flight
    if (lane != 0 || n_kb == 0) return;
    int c1, c2, c3;
    mbar_expect_tx(qbar, NP * Q_PANEL);
    coords(qpos, q0, h, b, c1, c2, c3);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      tma_load(sq + p * Q_PANEL, &tq, qbar, p * PANEL, c1, c2, c3);
    for (int i = 0; i < n_kb; ++i) {
      const int s = i % STAGES, use = i / STAGES;
      if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
      mbar_expect_tx(&full[s], 2 * KV_BYTES);
      int k1, k2, k3, v1, v2, v3;
      coords(kpos, i * BK, h, b, k1, k2, k3);
      coords(vpos, i * BK, h, b, v1, v2, v3);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        tma_load(sk + s * KV_BYTES + p * KV_PANEL, &tk, &full[s], p * PANEL,
                 k1, k2, k3);
        tma_load(sv + s * KV_BYTES + p * KV_PANEL, &tv, &full[s], p * PANEL,
                 v1, v2, v3);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. q0 + 64 wg + 63
  const int wg = warp / 4, w = warp % 4;
  const int g = lane / 4, c = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * w + g;       // and row0 + 8
  const int last_seen = q0 + 64 * wg + shift;   // last key of its row 0
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};   // m in log2 units

  if (n_kb > 0) mbar_wait(qbar, 0);
  const uint8_t* qw = sq + 64 * wg * ROW_BYTES;
  for (int i = 0; i < n_kb; ++i) {
    const int s = i % STAGES;
    const int k0 = i * BK;
    mbar_wait(&full[s], (i / STAGES) & 1);
    // a tile wholly in the causal future of this warpgroup's rows
    const bool skip = causal && k0 > last_seen + 63;
    if (!skip) {
      const uint8_t* kt = sk + s * KV_BYTES;
      const uint8_t* vt = sv + s * KV_BYTES;
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk % 4) * 32;   // 16 columns = 32 bytes
        wgmma_ss<BK, F16>(
            sc, sw128_desc(qw + (kk / 4) * Q_PANEL + off, 16, 1024),
            sw128_desc(kt + (kk / 4) * KV_PANEL + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin<BK / 2>(sc);

      const bool unmasked =
          k0 + BK <= t_len &&
          (!causal || k0 + BK - 1 <= last_seen);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (!unmasked) {
            const int col = k0 + 8 * j + 2 * c + (e & 1);
            const bool ok = col < t_len &&
                            (!causal || row0 + 8 * (e >> 1) + shift >= col);
            x = ok ? x : -INFINITY;
          }
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);   // finite: m starts at NEG
        corr[r] = fast_exp2(m[r] - m_new);
        m[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(sc[4 * j + e] - m[e >> 1]);  // masked: 0
          rs[e >> 1] += p;
          sc[4 * j + e] = p;
        }
      // P = hi + lo in the input dtype (see the header)
      uint32_t phi[BK / 16][4], plo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          split2<scalar_t>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1],
                           phi[kk][r], plo[kk][r]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];

      pin<D / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = sw128_desc(vt + kk * 16 * ROW_BYTES, KV_PANEL,
                                       1024);
        wgmma_rs<D, F16>(acc, phi[kk], dv);
        wgmma_rs<D, F16>(acc, plo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin<D / 2>(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ---- epilogue: each row's sum over its quad, then O and lse
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= t_len) continue;
    const float lc = fmaxf(l[r], 1e-20f);
    const float inv = 1.f / lc;
    scalar_t* orow = o + ((size_t(b) * t_len + row) * n_heads + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * c) = pack2<scalar_t>(
          acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    if (c == 0)
      lse[size_t(bh) * t_len + row] =
          (m[r] == NEG ? NEG : m[r] * LN2) + logf(lc);
  }
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, reached through the runtime, so the
// library needs no -lcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map (D, then T, H, B in the order of increasing stride) over a
// tensor of 16-bit elements with element strides st, sh, sb; boxes of 64
// columns by `rows` rows of T, 128-byte swizzled. *pos receives the map
// positions of T, H and B (see coords).
int make_map(CUtensorMap* map, const void* ptr, bool f16, int d, int t,
             int h, int b, long long st, long long sh, long long sb,
             int rows, int* pos) {
  EncodeTiled enc = encoder();
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
  cuuint32_t box[4] = {cuuint32_t(PANEL)};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  *pos = 0;
  for (int i = 0; i < 3; ++i) {
    const int which = order[i];
    gdim[i + 1] = cuuint64_t(size[which]);
    gstride[i] = cuuint64_t(stride[which]) * 2;
    box[i + 1] = which == 0 ? cuuint32_t(rows) : 1;
    *pos |= (i + 1) << (2 * which);
  }
  CUresult r = enc(map,
                   f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   4, const_cast<void*>(ptr), gdim, gstride, box, estride,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

template <typename scalar_t, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int h, int t, const long long* st, float scale, int causal,
           int q_offset, int k_offset, cudaStream_t stream) {
  constexpr bool f16 = std::is_same<scalar_t, __half>::value;
  constexpr int BK = Tiles<D>::BK;
  CUtensorMap tq, tk, tv;
  int qpos, kpos, vpos, err;
  if ((err = make_map(&tq, q, f16, D, t, h, b, st[2], st[1], st[0], BQ,
                      &qpos)) ||
      (err = make_map(&tk, k, f16, D, t, h, b, st[5], st[4], st[3], BK,
                      &kpos)) ||
      (err = make_map(&tv, v, f16, D, t, h, b, st[8], st[7], st[6], BK,
                      &vpos)))
    return err;
  constexpr int smem = smem_bytes<D>();
  auto kernel = flash_fwd_tc_kernel<scalar_t, D>;
  static unsigned long long attr_set = 0;   // one bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev >= 64 || !((attr_set >> dev) & 1)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
    if (dev < 64) attr_set |= 1ull << dev;
  }
  dim3 grid(b * h, (t + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(
      tq, tk, tv, static_cast<scalar_t*>(o), static_cast<float*>(lse), h, t,
      scale * LOG2E, causal, q_offset, k_offset, qpos, kpos, vpos);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 1 bfloat16, 2 float16; d: 64 or 128. q, k, v are (b, h, t, d)
// with unit stride in d; strides holds their element strides over
// (b, h, t): q's three, then k's, then v's. o is contiguous (b, t, h, d);
// lse contiguous f32 (b, h, t). Launches on `stream`, never synchronises,
// and returns 0, a cudaError_t, or one of this file's ERR_* codes.
extern "C" int flash_attn_fwd_tc(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int b, int h, int t,
                                 int d, const long long* strides, int dtype,
                                 float scale, int causal, int q_offset,
                                 int k_offset, void* stream) {
  if (b <= 0 || h <= 0 || t <= 0 || (long long)b * h > 0x7fffffffLL ||
      (t + BQ - 1) / BQ > MAX_Q_TILES)
    return ERR_SHAPE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, b, h, t, strides,
                                     scale, causal, q_offset, k_offset, s);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, b, h, t, strides,
                                      scale, causal, q_offset, k_offset, s);
  if (dtype == 2 && d == 64)
    return launch<__half, 64>(q, k, v, o, lse, b, h, t, strides, scale,
                              causal, q_offset, k_offset, s);
  if (dtype == 2 && d == 128)
    return launch<__half, 128>(q, k, v, o, lse, b, h, t, strides, scale,
                               causal, q_offset, k_offset, s);
  return ERR_SHAPE;
}

extern "C" const char* flash_attn_tc_error_string(int err) {
  switch (err) {
    case ERR_NO_ENCODER:
      return "cuTensorMapEncodeTiled is not available from the driver";
    case ERR_ENCODE:
      return "cuTensorMapEncodeTiled refused a tensor map (strides or "
             "base address not 16-byte aligned?)";
    case ERR_SHAPE:
      return "shape, dtype or head dimension the tensor-core kernel does "
             "not take";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}
