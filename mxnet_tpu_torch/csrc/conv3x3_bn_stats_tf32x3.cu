// Fused 3x3 stride-1 SAME convolution + BatchNorm statistics in fp32 on
// Hopper's tensor cores (sm_90a) as 3xTF32: kernel K3, route "tf32x3".
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py:conv3x3_bn_stats
// (:396, the pl.pallas_call at :446), which conv3x3_bn_relu_train (:467)
// wraps, for fp32 callers: fp32 is mxnet_tpu's default dtype. It computes
// what conv3x3_bn_stats.cu (the CUDA-core route, which stays for fp32
// inputs this kernel does not take) and conv3x3_bn_stats_tc.cu (16-bit)
// compute: for x (N, H, W, Cin) NHWC and w (3, 3, Cin, Cout) HWIO in f32,
//   acc[n, h, w, co] = sum_{kh, kw, ci} xpad[n, h + kh, w + kw, ci]
//                                       * w[kh, kw, ci, co]     (f32)
//   y     = acc                          (f32)
//   sum   = sum over n, h, w of acc      (f32, Cout)
//   sumsq = sum over n, h, w of acc^2    (f32, Cout)
// xpad is x with one zero row / column on every side.
//
// Takes: f32; Cin a multiple of 32 (one 128-byte swizzled TF32 row), Cout a
// multiple of 64; x and w contiguous with 16-byte-aligned bases
// (ops/kernels.py:_conv_route).
//
// Accuracy: every product is 3xTF32 (hopper.cuh): each f32 operand is split
// into a TF32 hi part (cvt.rna) and a TF32 lo part (the rounded rest), and
// a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b in f32 on wgmma. The
// dropped lo_a lo_b is ~2^-22 of |a b|; one TF32 pass would keep ~2^-11 and
// misses chip_smoke.py's tolerance for this route by more than 10x.
//
// Bound on the H100 SXM. Each of ResNet-50's four 3x3 shapes at N = 32
// (56x56x64, 28x28x128, 14x14x256, 7x7x512, Cin = Cout) is
// 2*9*N*H*W*Cin*Cout = 7.40 GFLOP; three TF32 passes at 495 TFLOP/s take
// 0.0448 ms (at the 67 TFLOP/s of f32 FMA on the CUDA cores 0.110 ms). x
// read once, y written once and w are 51.5 MB at 56x56x64 (0.0154 ms at
// 3.35 TB/s), less for the others. So operations bound every shape.
//
// Design: implicit GEMM, M = N*H*W output pixels, N = Cout, K = 9*Cin,
// after conv3x3_bn_stats_tc.cu.
// - A pre-pass kernel (pack_w_kernel), launched first on the same stream,
//   writes w once per call as TF32 hi and lo panels in K-major order,
//   wpack (2, 9, Cout, Cin), into a workspace the caller allocates: TF32
//   wgmma has no transpose flags, and HWIO w has Cout contiguous (the
//   MN-major B operand). It reads w once and writes it twice (18.9 MB at
//   C = 512, L2-resident for the main kernel).
// - One CTA owns BM = 64 * C output pixels (C consumer warpgroups of 64
//   rows) by BN output channels, plus one producer warp; the tiling is
//   (BM, BN) = (64, 64) (TILE_C, TILE_BN below). Its K loop runs over the 9
//   taps and, inside each, over Cin in chunks of 32, through a ring of 2
//   shared-memory stages guarded by full/empty mbarriers.
// - A, the shifted input tile of one tap, arrives by one TMA load in im2col
//   mode, as in the 16-bit kernel: a 4-D map (C, W, H, N) over x whose
//   pixel box has the corners of a SAME pad of 1, 32 f32 channels (128
//   bytes, 128-byte swizzle) per pixel and BM pixels per column, the tap
//   as the im2col offset; TMA zero-fills what falls outside the image, so
//   the halo costs no padded copy and the loop no bounds check. The layout
//   is K-major, as TF32 wgmma needs.
// - B_hi and B_lo, wpack[part, tap, n0:n0+BN, c0:c0+32], arrive by two TMA
//   loads through a tiled 3-D map (Cin, Cout, 2 * 9), K-major rows of 128
//   bytes.
// - A is split in registers: each consumer thread reads its TF32 A
//   fragment of every k8 step straight from the swizzled tile (rows g and
//   g + 8, columns c and c + 4; conflict-free under the swizzle), splits it
//   with split_tf32 and issues wgmma_rs_tf32. No A_lo goes to shared
//   memory, so the split needs no proxy fence and no barrier among the
//   warpgroups; the A tile is read once per stage by the thread that owns
//   each element.
// - Products: each k8 step issues A_lo B_hi + A_hi B_lo + A_hi B_hi
//   (m64nBNk8); lo lo is dropped. A stage's 12 products (32 channels of one
//   tap) go to an accumulator of their own, which the CUDA cores add to the
//   running f32 sum, rounded to nearest: the tensor cores' own accumulation
//   truncates, and over all 27 x Cin / 8 products of one accumulator its
//   bias reached 1e-5 of max|y| at Cin = 128 and 3.5e-5 at Cin = 512
//   (PERF.md). Each warpgroup waits for its stage's products before it
//   hands the stage back; the SM's other CTAs keep the tensor cores busy
//   meanwhile. Keeping one stage's products in flight while the next
//   stage's A fragments are split (two sets of fragment registers) was no
//   faster: ptxas serializes every wgmma of a kernel that reads an
//   accumulator while a product is in flight.
// - Epilogue: y is stored from the f32 fragment; rows at or past M are
//   neither stored nor summed. The statistics are those of the 16-bit
//   kernel: each thread sums its two rows per column, xor shuffles add the
//   8 lanes of a column, the warps' sums are added in a fixed order through
//   shared memory into per-M-tile partials (2, M tiles, Cout), which
//   reduce_stats_kernel (bn_stats.cuh) adds in a fixed order. No f32
//   atomics: two launches are bitwise equal.
//
// Shared memory: 2 stages x (BM + 2 BN) x 128 bytes of tiles, plus the
// warps' column sums: 51 KB. Registers (116 a thread) then allow three CTAs
// per SM, each with a ring of its own, so that while one CTA waits for its
// products or its tiles the others issue theirs: 2 stages were 10 % faster
// than 3 or 4 (two CTAs per SM). ptxas must report no spills (chip_smoke.py
// phase a checks it).
//
// Tiles: 64 x 64, fixed: its grid (M / 64) x (Cout / 64) has at least 200
// CTAs at every ResNet-50 shape at N = 32. tools/torch_k3_variants.py times
// the others (PERF.md): 128 x 64 (two warpgroups sharing one ring) was
// slower at every shape; 128 x 128 and 64 x 128 spill, hold fewer CTAs per
// SM, and were faster only at 14x14x256 (64 x 128, by 4 %).
//
// What holds it back (PERF.md has the numbers): it reaches 36-49 % of the
// 3xTF32 bound, and without two of its three passes it is only 19-31 %
// faster, so the products are not most of its time. Each warpgroup drains
// its products at every stage, and each CTA loads A again for every tap
// and B (hi and lo) again for every M tile, (BM + 2 BN) x 128 bytes per
// 3 x 2 x BM x BN x 32 TF32 FLOP: 5.7-7.5 TB/s from L2 into shared memory
// at these shapes. The pre-pass rewrites w at every call.
#include "bn_stats.cuh"
#include "hopper.cuh"

namespace {

constexpr int SMEM_PER_SM = 232448;
constexpr int TILE_C = 1, TILE_BN = 64;     // the tiling: (64 C, BN)

// C consumer warpgroups (BM = 64 C rows) by BN output channels.
template <int C, int BN>
struct Cfg {
  static constexpr int BM = 64 * C;
  static constexpr int NT = 128 * C + 32;   // + one producer warp
  static constexpr int STAGES = 2;
  static constexpr int A_BYTES = BM * ROW_BYTES;    // 32 channels a pixel
  static constexpr int B_BYTES = BN * ROW_BYTES;    // 32 Cin a channel
  static constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;   // A, B hi, lo
  static constexpr int RED_FLOATS = 2 * 4 * C * BN;  // sum, sumsq per warp
  // the tiles, the warps' sums, 2 * STAGES mbarriers, and 1 KB to align
  // the tiles to the 1024-byte swizzle atom
  static constexpr int SMEM =
      STAGES * STAGE_BYTES + RED_FLOATS * 4 + 2 * STAGES * 8 + 1024;
  // CTAs per SM that shared memory allows, and that leave a thread at
  // least 128 of the SM's 65536 registers (two accumulators and the A
  // fragments of a stage): three for 64 x 64 tiles
  static constexpr int FIT_SMEM = SMEM_PER_SM / (SMEM + 1024);
  static constexpr int FIT_REGS = 65536 / (NT * 128);
  static constexpr int FIT = FIT_SMEM < FIT_REGS ? FIT_SMEM : FIT_REGS;
  static constexpr int MIN_BLOCKS = FIT < 1 ? 1 : FIT > 3 ? 3 : FIT;
};

// wpack[part][tap][co][ci] = part (0: hi, 1: lo) of the TF32 split of
// w[tap][ci][co]: a 32 x 32 (ci, co) tile transposed through shared memory,
// read and written in rows of 32 consecutive floats.
// Grid: (Cout / 32, Cin / 32, 9); block (32, 8).
__global__ void __launch_bounds__(256)
pack_w_kernel(const float* __restrict__ w, float* __restrict__ wpack,
              int cin, int cout) {
  __shared__ float tile[32][33];
  const int tap = blockIdx.z;
  const int co0 = blockIdx.x * 32, ci0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float* src = w + size_t(tap) * cin * cout;
#pragma unroll
  for (int i = ty; i < 32; i += 8)
    tile[i][tx] = src[size_t(ci0 + i) * cout + co0 + tx];
  __syncthreads();
  float* hi = wpack + size_t(tap) * cout * cin;
  float* lo = hi + size_t(9) * cout * cin;
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    uint32_t h, l;
    split_tf32(tile[tx][i], h, l);
    const size_t at = size_t(co0 + i) * cin + ci0 + tx;
    hi[at] = __uint_as_float(h);
    lo[at] = __uint_as_float(l);
  }
}

// Accumulator fragment of wgmma m64nN f32, for the thread at lane
// (g = lane / 4, c = lane % 4) of warp w in its warpgroup: register
// 4j + e holds row 16w + g + 8 (e / 2), column 8j + 2c + e % 2. Its TF32 A
// fragment of a k8 step (hopper.cuh): rows 16w + g and 16w + g + 8,
// columns c and c + 4.
//
// Grid: (M tiles, Cout / BN).
template <int C, int BN>
__global__ void __launch_bounds__(Cfg<C, BN>::NT, Cfg<C, BN>::MIN_BLOCKS)
conv3x3_tf32x3_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tw,
                      float* __restrict__ y, float* __restrict__ part,
                      int height, int width, int cin, int cout,
                      int m_total) {
  using K = Cfg<C, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(tiles + K::STAGES * K::STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + K::RED_FLOATS);
  uint64_t* empty = full + K::STAGES;

  const int m0 = blockIdx.x * K::BM;
  const int n0 = blockIdx.y * BN;
  const int chunks = cin / PANEL32;
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
      const int tap = it / chunks, c0 = (it % chunks) * PANEL32;
      uint8_t* a = tiles + s * K::STAGE_BYTES;
      uint8_t* b = a + K::A_BYTES;
      mbar_expect_tx(&full[s], K::STAGE_BYTES);
      // the im2col position of output pixel (img, p0, q0) is its input
      // pixel for the tap (0, 0): one up and one left
      tma_load_im2col(a, &tx, &full[s], c0, q0 - 1, p0 - 1, img,
                      uint16_t(tap % 3), uint16_t(tap / 3));
      tma_load_3d(b, &tw, &full[s], c0, n0, tap);                  // hi
      tma_load_3d(b + K::B_BYTES, &tw, &full[s], c0, n0, 9 + tap);  // lo
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. m0 + 64 wg + 63
  const int wg = warp / 4, w = warp % 4, g = lane / 4, c = lane % 4;
  // this thread's A elements in a stage: row 16w + g of its warpgroup's 64
  // (and that + 8, 1024 bytes on, with the same swizzle phase g), column
  // 8kk + c in 16-byte chunk 2kk, column 8kk + c + 4 in chunk 2kk + 1
  const int a_row = (64 * wg + 16 * w + g) * ROW_BYTES + 4 * c;
  // a stage's products go to part, which each stage's first wgmma
  // overwrites; acc adds the stages on the CUDA cores, rounded to nearest
  float acc[BN / 2], part_acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < n_iter; ++it) {
    const int s = it % K::STAGES;
    mbar_wait(&full[s], (it / K::STAGES) & 1);
    const uint8_t* a = tiles + s * K::STAGE_BYTES + a_row;
    const uint8_t* bh = tiles + s * K::STAGE_BYTES + K::A_BYTES;
    const uint8_t* bl = bh + K::B_BYTES;
    uint32_t hi[PANEL32 / 8][4], lo[PANEL32 / 8][4];
#pragma unroll
    for (int kk = 0; kk < PANEL32 / 8; ++kk) {
      const int c_lo = ((2 * kk) ^ g) << 4, c_hi = ((2 * kk + 1) ^ g) << 4;
      split_tf32(*reinterpret_cast<const float*>(a + c_lo), hi[kk][0],
                 lo[kk][0]);
      split_tf32(*reinterpret_cast<const float*>(a + 8 * ROW_BYTES + c_lo),
                 hi[kk][1], lo[kk][1]);
      split_tf32(*reinterpret_cast<const float*>(a + c_hi), hi[kk][2],
                 lo[kk][2]);
      split_tf32(*reinterpret_cast<const float*>(a + 8 * ROW_BYTES + c_hi),
                 hi[kk][3], lo[kk][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PANEL32 / 8; ++kk) {
      const uint64_t dh = sw128_desc(bh + kk * 32, 16, 1024);
      wgmma_rs_tf32<BN>(part_acc, lo[kk], dh, kk > 0);
      wgmma_rs_tf32<BN>(part_acc, hi[kk],
                        sw128_desc(bl + kk * 32, 16, 1024));
      wgmma_rs_tf32<BN>(part_acc, hi[kk], dh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin<BN / 2>(part_acc);
    // this warp's products of the stage are done: hand its buffers back
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part_acc[i];
  }

  // ---- epilogue
  const int row = m0 + 64 * wg + 16 * w + g;       // and row + 8
  const bool ok0 = row < m_total, ok1 = row + 8 < m_total;
  float* yb = y + n0 + 2 * c;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    if (ok0)
      *reinterpret_cast<float2*>(yb + size_t(row) * cout + 8 * j) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (ok1)
      *reinterpret_cast<float2*>(yb + size_t(row + 8) * cout + 8 * j) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
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
// x (n, h, w, cin) f32 as an im2col map (C, W, H, N): pixel boxes of a 3x3
// SAME conv (corners -1 and -1 on W and H), 32 channels, bm pixels.
int make_x_map(CUtensorMap* map, const void* x, int n, int h, int w,
               int cin, int bm) {
  return make_im2col_map(map, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, n, h, w,
                         cin, -1, -1, -1, -1, 1, 1, PANEL32, bm,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

// wpack (2 * 9, cout, cin) f32 as a tiled map (Cin, Cout, 18), boxes of
// 32 x bn x 1.
int make_w_map(CUtensorMap* map, const void* wpack, int cin, int cout,
               int bn) {
  static const EncodeTiled enc =
      reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
  if (!enc) return ERR_NO_ENCODER;
  const cuuint64_t dim[3] = {cuuint64_t(cin), cuuint64_t(cout), 18};
  const cuuint64_t stride[2] = {cuuint64_t(cin) * 4,
                                cuuint64_t(cout) * cin * 4};
  const cuuint32_t box[3] = {PANEL32, cuuint32_t(bn), 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                   const_cast<void*>(wpack), dim, stride, box, estride,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

cudaError_t pack_w(const void* w, void* wpack, int cin, int cout,
                   cudaStream_t stream) {
  pack_w_kernel<<<dim3(cout / 32, cin / 32, 9), dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(w), static_cast<float*>(wpack), cin, cout);
  return cudaGetLastError();
}

template <int C, int BN>
int launch(const void* x, const void* w, void* wpack, void* y, void* part,
           void* sums, int n, int h, int wd, int cin, int cout,
           cudaStream_t stream) {
  using K = Cfg<C, BN>;
  CUtensorMap tx, tw;
  int err;
  if ((err = make_x_map(&tx, x, n, h, wd, cin, K::BM)) ||
      (err = make_w_map(&tw, wpack, cin, cout, BN)))
    return err;
  auto kernel = conv3x3_tf32x3_kernel<C, BN>;
  static unsigned long long attr_set = 0;   // one bit per device
  if ((err = allow_smem(kernel, K::SMEM, attr_set))) return err;
  cudaError_t e = pack_w(w, wpack, cin, cout, stream);
  if (e != cudaSuccess) return int(e);
  const int m_total = n * h * wd;
  const int m_tiles = (m_total + K::BM - 1) / K::BM;
  kernel<<<dim3(m_tiles, cout / BN), K::NT, K::SMEM, stream>>>(
      tx, tw, static_cast<float*>(y), static_cast<float*>(part), h, wd, cin,
      cout, m_total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  return int(reduce_stats(part, sums, m_tiles, cout, stream));
}

bool channels_ok(int cin, int cout) {
  return cin > 0 && cout > 0 && cin % PANEL32 == 0 && cout % 64 == 0;
}

}  // namespace

// Pixels per CTA: the partials buffer holds ceil(n*h*w / this) tiles.
extern "C" int conv3x3_tf32x3_block_m() { return Cfg<TILE_C, TILE_BN>::BM; }

// x (n, h, w, cin), w (3, 3, cin, cout), y (n, h, w, cout) contiguous f32,
// x and w 16-byte aligned; cin a multiple of 32, cout of 64. wpack is f32
// scratch of 2 * 9 * cout * cin (the packed w, written here), part f32
// scratch of 2 * ceil(n*h*w / conv3x3_tf32x3_block_m()) * cout; sums is f32
// (2, cout): sum then sum of squares. Launches the pack, the conv and the
// reduction on `stream`, never synchronises, and returns 0, a cudaError_t,
// or one of hopper.cuh's ERR_* codes.
extern "C" int conv3x3_bn_stats_tf32x3(const void* x, const void* w,
                                       void* wpack, void* y, void* part,
                                       void* sums, int n, int height,
                                       int width, int cin, int cout,
                                       void* stream) {
  if (n <= 0 || height <= 0 || width <= 0 || !channels_ok(cin, cout) ||
      cout % TILE_BN ||
      (long long)n * height * width * (cin > cout ? cin : cout) > 0x7fffffffLL)
    return ERR_SHAPE;
  return launch<TILE_C, TILE_BN>(x, w, wpack, y, part, sums, n, height,
                                 width, cin, cout,
                                 static_cast<cudaStream_t>(stream));
}

// The pre-pass alone: wpack (2, 9, cout, cin) from w (3, 3, cin, cout),
// both contiguous f32; for holding it to its plain version.
extern "C" int conv3x3_tf32x3_pack_w(const void* w, void* wpack, int cin,
                                     int cout, void* stream) {
  if (!channels_ok(cin, cout)) return ERR_SHAPE;
  return int(pack_w(w, wpack, cin, cout, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* conv3x3_tf32x3_error_string(int err) {
  switch (err) {
    case ERR_NO_ENCODER:
      return "cuTensorMapEncodeIm2col or cuTensorMapEncodeTiled is not "
             "available from the driver";
    case ERR_ENCODE:
      return "the driver refused a tensor map (strides or base address not "
             "16-byte aligned?)";
    case ERR_SHAPE:
      return "shape the 3xTF32 kernel does not take";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}
