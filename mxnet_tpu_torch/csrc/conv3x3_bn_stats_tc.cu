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
//   reduce_stats_kernel (bn_stats.cuh) adds in a fixed order. No f32
//   atomics: two launches are bitwise equal.
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
#include <type_traits>

#include "bn_stats.cuh"
#include "hopper.cuh"

namespace {

constexpr int SMEM_PER_SM = 232448;

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
    mbar_init_fence();
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
      wgmma_ss<BN, F16, 1>(acc, sw128_desc(a + kk * 32, 16, 1024),
                           sw128_desc(b + kk * 16 * ROW_BYTES,
                                      PANEL * ROW_BYTES, 1024),
                           1);
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

// ------------------------------------------------------------------ host
// x (n, h, w, cin) as an im2col map (C, W, H, N): pixel boxes of a 3x3
// SAME conv (corners -1 and -1 on W and H), 64 channels, bm pixels.
int make_x_map(CUtensorMap* map, const void* x, CUtensorMapDataType dt,
               int n, int h, int w, int cin, int bm) {
  return make_im2col_map(map, x, dt, 2, n, h, w, cin, -1, -1, -1, -1, 1, 1,
                         PANEL, bm, CU_TENSOR_MAP_SWIZZLE_128B);
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
  if ((err = allow_smem(kernel, K::SMEM, attr_set))) return err;
  const int m_total = n * h * wd;
  const int m_tiles = (m_total + K::BM - 1) / K::BM;
  kernel<<<dim3(m_tiles, cout / BN), K::NT, K::SMEM, stream>>>(
      tx, tw, static_cast<T*>(y), static_cast<float*>(part), h, wd, cin,
      cout, m_total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  return int(reduce_stats(part, sums, m_tiles, cout, stream));
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
// synchronises, and returns 0, a cudaError_t, or one of hopper.cuh's
// ERR_* codes.
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
