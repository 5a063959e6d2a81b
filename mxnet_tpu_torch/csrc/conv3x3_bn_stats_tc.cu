// Fused 3x3 stride-1 SAME convolution + BatchNorm statistics on Hopper's
// tensor cores (sm_90a): kernel K3, tensor-core route.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py:conv3x3_bn_stats
// (:396, the pl.pallas_call at :446), which conv3x3_bn_relu_train (:467)
// wraps. It computes what conv3x3_bn_stats.cu, the CUDA-core route, computes
// (that kernel stays for fp32 and for channel counts this one does not
// take): for x (N, H, W, Cin) NHWC and w (3, 3, Cin, Cout) HWIO of one
// 16-bit dtype,
//   acc[n, h, w, co] = sum_{kh, kw, ci} xpad[n, h + kh, w + kw, ci]
//                                       * w[kh, kw, ci, co]     (f32)
//   y     = acc rounded to the input dtype
//   sum   = sum over n, h, w of acc      (f32, Cout)
//   sumsq = sum over n, h, w of acc^2    (f32, Cout)
// xpad is x with one zero row / column on every side. The statistics come
// from the f32 accumulator, not from the rounded y.
//
// Takes: bf16 and fp16; Cin and Cout multiples of 64; x and w contiguous
// with 16-byte-aligned bases (ops/kernels.py:_conv_route). The tile sizes
// come from the caller (ops/kernels.py:_conv_tiles).
//
// Bound on the H100 SXM. Each of ResNet-50's four 3x3 shapes at N = 32
// (56x56x64, 28x28x128, 14x14x256, 7x7x512, Cin = Cout) is
// 2*9*N*H*W*Cin*Cout = 7.40 GFLOP: 7.5 us at the 989 TFLOP/s bf16 peak.
// x read once, y written once and w are 25.8 MB at 56x56x64 (7.7 us at
// 3.35 TB/s), less for the others. So 56x56x64 is bound by bytes, by a
// hair, and the deeper shapes by operations.
//
// Design: implicit GEMM, M = N*H*W output pixels, N = Cout, K = 9*Cin.
// - One CTA owns BM = 64 * C output pixels (C = 1 or 2 consumer warpgroups
//   of 64 rows) by BN = 64 or 128 output channels, plus one producer warp.
//   Its K loop runs over the 9 taps and, inside each, over Cin in chunks of
//   64, through a ring of STAGES shared-memory stages guarded by full/empty
//   mbarriers. Every product is wgmma m64nBNk16 with both operands in
//   shared memory, accumulated in f32 registers; each warpgroup keeps one
//   group of 4 wgmmas in flight while it waits for the next stage.
// - A, the shifted input tile of one tap, arrives by one TMA load in
//   im2col mode: a 4-D map (C, W, H, N) over x whose pixel box has the
//   corners of a SAME pad of 1 (lower -1, upper -1), 64 channels (128
//   bytes, 128-byte swizzle) per pixel and BM pixels per column. The tap
//   (kh, kw) is the load's im2col offset. TMA zero-fills what falls outside
//   the image, so the halo costs no padded copy in HBM (the copy that cost
//   the TPU kernel its win) and the loop no bounds check, and a tile that
//   crosses rows or images (every 7x7 tile does) comes out right. The nine
//   taps read x again from L2 (x is 1.6-12.8 MB, L2 50 MB), not from HBM.
// - B, w[tap, c0:c0+64, n0:n0+BN], is read in place through a tiled 3-D
//   map (Cout, Cin, 9) in panels of 64 output channels: Cout is contiguous,
//   so it is the MN-major B operand (transpose flag set), and the weight is
//   never transposed in HBM.
// - Epilogue: y is stored from the f32 fragment in the input dtype; rows at
//   or past M are neither stored nor summed. Each thread sums its two rows
//   per column; xor shuffles add the 8 lanes that hold the same column; the
//   warps' sums are added in a fixed order through shared memory. Each CTA
//   writes its tile's sums to per-M-tile partials (2, M tiles, Cout), which
//   reduce_stats_kernel adds in a fixed order. No f32 atomics: two launches
//   are bitwise equal.
//
// Shared memory: STAGES x (BM + BN) x 128 bytes of tiles, plus the warps'
// column sums. (BM, BN) = (128, 128) takes 3 stages, 105 KB; (128, 64),
// (64, 128) 4 stages, 101 KB; (64, 64) 4 stages, 67 KB: two or three CTAs
// per SM. ptxas must report no spills (chip_smoke.py phase a checks it).
//
// Tiles (ops/kernels.py:_conv_tiles, chosen from the variants that
// tools/torch_k3_variants.py times): the first of 128 x 128, 64 x 128,
// 128 x 64, 64 x 64 whose grid gives each of the card's SMs a CTA, else
// 64 x 64. Small grids (N = 1-4 at the deep shapes) leave SMs idle; no
// caller in the repo sends them yet.
//
// What holds it back (PERF.md has the numbers): each CTA loads A again for
// every tap and B again for every M tile, (BM + BN) x 128 bytes per
// 2 x BM x BN x 64 FLOP, 32 FLOP per byte for 64 x 64 tiles and 64 for
// 128 x 128; the 64-row tiles move 7-8 TB/s of tiles into shared memory,
// mostly from L2. Tiles of 128 rows move half that, but fill the card in
// uneven waves (196 CTAs on 132 SMs) and, at Cin = 64, run a K loop of
// only 9 steps between a cold ring and an epilogue that nothing overlaps.
// Larger tiles leave SMs idle at these shapes, 2 stages starve the ring
// and 6 cost CTAs per SM, and the statistics take 4-9 %. The next steps
// are clusters whose CTAs share the TMA loads of B (or A) by multicast,
// and a persistent kernel that keeps w in shared memory and overlaps one
// tile's epilogue with the next tile's loads.
//
// Prediction, written before the first full run on the card (H100 SXM,
// N = 32, bf16, device time): 0.020-0.035 ms at 56x56x64 (L2 traffic of
// the nine taps and the y stores), 0.020-0.040 ms at 28x28x128 and
// 14x14x256, 0.025-0.050 ms at 7x7x512 (200 CTAs of 64 x 64 on 132 SMs:
// the SMs with two take twice as long): 150-370 TFLOP/s, 10-25x the
// CUDA-core kernel.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int PANEL = 64;          // 16-bit channels per swizzled row
constexpr int ROW_BYTES = 128;     // bytes per swizzled row
constexpr int SMEM_PER_SM = 232448;
constexpr int RC = 32;             // channels per reduction block
constexpr int RS = 32;             // partial-sum segments per channel
constexpr int ERR_NO_ENCODER = 1000;  // a tensor-map encoder is missing
constexpr int ERR_ENCODE = 1001;      // the driver refused a tensor map
constexpr int ERR_SHAPE = 1002;       // a shape or tiling not taken

// C consumer warpgroups (BM = 64 C rows) by BN output channels.
template <int C, int BN>
struct Cfg {
  static constexpr int BM = 64 * C;
  static constexpr int NT = 128 * C + 32;   // + one producer warp
  static constexpr int STAGES = C * BN >= 256 ? 3 : 4;
  static constexpr int A_BYTES = BM * ROW_BYTES;
  static constexpr int B_BYTES = BN * ROW_BYTES;   // 64 Cin rows x BN
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int RED_FLOATS = 2 * 4 * C * BN;  // sum, sumsq per warp
  // the tiles, the warps' sums, 2 * STAGES mbarriers, and 1 KB to align
  // the tiles to the 1024-byte swizzle atom
  static constexpr int SMEM =
      STAGES * STAGE_BYTES + RED_FLOATS * 4 + 2 * STAGES * 8 + 1024;
  // CTAs per SM that shared memory allows, and that leave a thread at
  // least 96 of the SM's 65536 registers
  static constexpr int FIT_SMEM = SMEM_PER_SM / (SMEM + 1024);
  static constexpr int FIT_REGS = 65536 / (NT * 96);
  static constexpr int FIT = FIT_SMEM < FIT_REGS ? FIT_SMEM : FIT_REGS;
  static constexpr int MIN_BLOCKS = FIT < 1 ? 1 : FIT > 3 ? 3 : FIT;
};

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

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
// The K-major A: SBO = 1024 (8 rows of 128 bytes), LBO unused. The
// MN-major B: SBO = 1024 (8 K-rows), LBO = the stride between panels of
// 64 N-columns.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
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

// Only the consumer warpgroups meet here; the producer warp has left.
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// D (64 x N, f32) += A (64 x 16, K-major) B (16 x N, MN-major), both from
// shared memory. F16 picks fp16 inputs over bf16.
template <int N, bool F16>
__device__ void wgmma_ss(float* d, uint64_t da, uint64_t db);

template <> __device__ __forceinline__ void
wgmma_ss<64, false>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
template <> __device__ __forceinline__ void
wgmma_ss<128, false>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
template <> __device__ __forceinline__ void
wgmma_ss<64, true>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
template <> __device__ __forceinline__ void
wgmma_ss<128, true>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
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

// Accumulator fragment of wgmma m64nN f32, for the thread at lane
// (g = lane / 4, c = lane % 4) of warp w in its warpgroup: register
// 4j + e holds row 16w + g + 8 (e / 2), column 8j + 2c + e % 2.
//
// Grid: (M tiles, Cout / BN).
template <typename T, int C, int BN>
__global__ void __launch_bounds__(Cfg<C, BN>::NT, Cfg<C, BN>::MIN_BLOCKS)
conv3x3_tc_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw,
                  T* __restrict__ y, float* __restrict__ part, int height,
                  int width, int cin, int cout, int m_total) {
  using K = Cfg<C, BN>;
  constexpr bool F16 = std::is_same<T, __half>::value;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(tiles + K::STAGES * K::STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + K::RED_FLOATS);
  uint64_t* empty = full + K::STAGES;

  const int m0 = blockIdx.x * K::BM;
  const int n0 = blockIdx.y * BN;
  const int chunks = cin / PANEL;
  const int n_iter = 9 * chunks;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < K::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4 * C) {
    // ---- producer: one thread keeps the TMA loads in flight
    if (lane != 0) return;
    const int hw = height * width;
    const int img = m0 / hw, rem = m0 - img * hw;
    const int p0 = rem / width, q0 = rem - p0 * width;
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % K::STAGES, use = it / K::STAGES;
      if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
      const int tap = it / chunks, c0 = (it % chunks) * PANEL;
      uint8_t* a = tiles + s * K::STAGE_BYTES;
      uint8_t* b = a + K::A_BYTES;
      mbar_expect_tx(&full[s], K::STAGE_BYTES);
      // the im2col position of output pixel (img, p0, q0) is its input
      // pixel for the tap (0, 0): one up and one left
      tma_load_im2col(a, &tx, &full[s], c0, q0 - 1, p0 - 1, img,
                      uint16_t(tap % 3), uint16_t(tap / 3));
#pragma unroll
      for (int p = 0; p < BN / PANEL; ++p)
        tma_load_3d(b + p * PANEL * ROW_BYTES, &tw, &full[s], n0 + p * PANEL,
                    c0, tap);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. m0 + 64 wg + 63
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % K::STAGES;
    mbar_wait(&full[s], (it / K::STAGES) & 1);
    const uint8_t* a = tiles + s * K::STAGE_BYTES + wg * 64 * ROW_BYTES;
    const uint8_t* b = tiles + s * K::STAGE_BYTES + K::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PANEL / 16; ++kk)
      wgmma_ss<BN, F16>(acc, sw128_desc(a + kk * 32, 16, 1024),
                        sw128_desc(b + kk * 16 * ROW_BYTES,
                                   PANEL * ROW_BYTES, 1024));
    wgmma_commit();
    // the previous stage's products are done: hand its buffers back
    wgmma_wait<1>();
    if (it > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(it - 1) % K::STAGES]);
    }
  }
  wgmma_wait<0>();
  pin<BN / 2>(acc);

  // ---- epilogue
  const int w = warp % 4, g = lane / 4, c = lane % 4;
  const int row = m0 + 64 * wg + 16 * w + g;       // and row + 8
  const bool ok0 = row < m_total, ok1 = row + 8 < m_total;
  T* yb = y + n0 + 2 * c;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    if (ok0)
      *reinterpret_cast<uint32_t*>(yb + size_t(row) * cout + 8 * j) =
          pack2<T>(acc[4 * j], acc[4 * j + 1]);
    if (ok1)
      *reinterpret_cast<uint32_t*>(yb + size_t(row + 8) * cout + 8 * j) =
          pack2<T>(acc[4 * j + 2], acc[4 * j + 3]);
  }
  // statistics: the thread's two rows, the 8 lanes of each column (xor
  // over the lane bits of g), then the warps in order
  float* red_s = red;
  float* red_q = red + 4 * C * BN;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v0 = ok0 ? acc[4 * j + e] : 0.f;
      const float v1 = ok1 ? acc[4 * j + 2 + e] : 0.f;
      float s = v0 + v1, q = v0 * v0 + v1 * v1;
#pragma unroll
      for (int x = 4; x < 32; x <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, x);
        q += __shfl_xor_sync(0xffffffffu, q, x);
      }
      if (g == 0) {
        red_s[warp * BN + 8 * j + 2 * c + e] = s;
        red_q[warp * BN + 8 * j + 2 * c + e] = q;
      }
    }
  consumers_sync(128 * C);
  for (int col = threadIdx.x; col < BN; col += 128 * C) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < 4 * C; ++i) {
      s += red_s[i * BN + col];
      q += red_q[i * BN + col];
    }
    const size_t off = size_t(blockIdx.x) * cout + n0 + col;
    part[off] = s;
    part[size_t(gridDim.x) * cout + off] = q;
  }
}

// sums[0][c] = sum over M tiles of part[0][t][c], sums[1][c] likewise, in
// a fixed order: segment g takes tiles g, g + RS, ... in turn, then the RS
// segments are added in order.
__global__ void __launch_bounds__(RC * RS)
reduce_stats_kernel(const float* __restrict__ part, float* __restrict__ sums,
                    int m_tiles, int cout) {
  __shared__ float ss[RS][RC + 1];
  __shared__ float sq[RS][RC + 1];
  const int lane = threadIdx.x;
  const int seg = threadIdx.y;
  const int c = blockIdx.x * RC + lane;
  float s = 0.f, q = 0.f;
  if (c < cout) {
    for (int t = seg; t < m_tiles; t += RS) {
      s += part[(size_t)t * cout + c];
      q += part[(size_t)(m_tiles + t) * cout + c];
    }
  }
  ss[seg][lane] = s;
  sq[seg][lane] = q;
  __syncthreads();
  if (seg == 0 && c < cout) {
    float a = 0.f, b = 0.f;
    for (int g = 0; g < RS; ++g) {
      a += ss[g][lane];
      b += sq[g][lane];
    }
    sums[c] = a;
    sums[cout + c] = b;
  }
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const int*, const int*,
                                 cuuint32_t, cuuint32_t, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A driver entry point reached through the runtime, so the library needs
// no -lcuda; nullptr if the driver lacks it.
void* driver_entry(const char* name) {
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

// x (n, h, w, cin) as an im2col map (C, W, H, N): pixel boxes of a 3x3
// SAME conv (corners -1 and -1 on W and H), 64 channels, bm pixels.
int make_x_map(CUtensorMap* map, const void* x, CUtensorMapDataType dt,
               int n, int h, int w, int cin, int bm) {
  static const EncodeIm2col enc =
      reinterpret_cast<EncodeIm2col>(driver_entry("cuTensorMapEncodeIm2col"));
  if (!enc) return ERR_NO_ENCODER;
  const cuuint64_t dim[4] = {cuuint64_t(cin), cuuint64_t(w), cuuint64_t(h),
                             cuuint64_t(n)};
  const cuuint64_t stride[3] = {cuuint64_t(cin) * 2,
                                cuuint64_t(w) * cin * 2,
                                cuuint64_t(h) * w * cin * 2};
  const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  CUresult r = enc(map, dt, 4, const_cast<void*>(x), dim, stride, lower,
                   upper, PANEL, cuuint32_t(bm), estride,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

// w (9, cin, cout) as a tiled map (Cout, Cin, 9), boxes of 64 x 64 x 1.
int make_w_map(CUtensorMap* map, const void* w, CUtensorMapDataType dt,
               int cin, int cout) {
  static const EncodeTiled enc =
      reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
  if (!enc) return ERR_NO_ENCODER;
  const cuuint64_t dim[3] = {cuuint64_t(cout), cuuint64_t(cin), 9};
  const cuuint64_t stride[2] = {cuuint64_t(cout) * 2,
                                cuuint64_t(cin) * cout * 2};
  const cuuint32_t box[3] = {PANEL, PANEL, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  CUresult r = enc(map, dt, 3, const_cast<void*>(w), dim, stride, box,
                   estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

template <typename T, int C, int BN>
int launch(const void* x, const void* w, void* y, void* part, void* sums,
           int n, int h, int wd, int cin, int cout, cudaStream_t stream) {
  using K = Cfg<C, BN>;
  const CUtensorMapDataType dt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tx, tw;
  int err;
  if ((err = make_x_map(&tx, x, dt, n, h, wd, cin, K::BM)) ||
      (err = make_w_map(&tw, w, dt, cin, cout)))
    return err;
  auto kernel = conv3x3_tc_kernel<T, C, BN>;
  static unsigned long long attr_set = 0;   // one bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev >= 64 || !((attr_set >> dev) & 1)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K::SMEM);
    if (e != cudaSuccess) return int(e);
    if (dev < 64) attr_set |= 1ull << dev;
  }
  const int m_total = n * h * wd;
  const int m_tiles = (m_total + K::BM - 1) / K::BM;
  kernel<<<dim3(m_tiles, cout / BN), K::NT, K::SMEM, stream>>>(
      tx, tw, static_cast<T*>(y), static_cast<float*>(part), h, wd, cin,
      cout, m_total);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  reduce_stats_kernel<<<(cout + RC - 1) / RC, dim3(RC, RS), 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(sums), m_tiles,
      cout);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w, void* y, void* part, void* sums,
             int n, int h, int wd, int cin, int cout, int bm, int bn,
             cudaStream_t s) {
  if (bm == 128 && bn == 128)
    return launch<T, 2, 128>(x, w, y, part, sums, n, h, wd, cin, cout, s);
  if (bm == 128 && bn == 64)
    return launch<T, 2, 64>(x, w, y, part, sums, n, h, wd, cin, cout, s);
  if (bm == 64 && bn == 128)
    return launch<T, 1, 128>(x, w, y, part, sums, n, h, wd, cin, cout, s);
  if (bm == 64 && bn == 64)
    return launch<T, 1, 64>(x, w, y, part, sums, n, h, wd, cin, cout, s);
  return ERR_SHAPE;
}

}  // namespace

// dtype: 1 bfloat16, 2 float16. x (n, h, w, cin), w (3, 3, cin, cout),
// y (n, h, w, cout) contiguous in that dtype, x and w 16-byte aligned;
// cin and cout multiples of 64, cout of bn. Tiles: bm in {64, 128}, bn in
// {64, 128}. part is f32 scratch of 2 * ceil(n*h*w / bm) * cout; sums is
// f32 (2, cout): sum then sum of squares. Launches on `stream`, never
// synchronises, and returns 0, a cudaError_t, or one of this file's ERR_*
// codes.
extern "C" int conv3x3_bn_stats_tc(const void* x, const void* w, void* y,
                                   void* part, void* sums, int n, int height,
                                   int width, int cin, int cout, int dtype,
                                   int bm, int bn, void* stream) {
  if (n <= 0 || height <= 0 || width <= 0 || cin <= 0 || cout <= 0 ||
      cin % PANEL || cout % PANEL || bn <= 0 || cout % bn ||
      (long long)n * height * width * (cin > cout ? cin : cout) > 0x7fffffffLL)
    return ERR_SHAPE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, y, part, sums, n, height, width,
                                   cin, cout, bm, bn, s);
  if (dtype == 2)
    return dispatch<__half>(x, w, y, part, sums, n, height, width, cin, cout,
                            bm, bn, s);
  return ERR_SHAPE;
}

extern "C" const char* conv3x3_tc_error_string(int err) {
  switch (err) {
    case ERR_NO_ENCODER:
      return "cuTensorMapEncodeIm2col or cuTensorMapEncodeTiled is not "
             "available from the driver";
    case ERR_ENCODE:
      return "the driver refused a tensor map (strides or base address not "
             "16-byte aligned?)";
    case ERR_SHAPE:
      return "shape, dtype or tiling the tensor-core kernel does not take";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}
