// K5's int8 GEMM core on Hopper's tensor cores (sm_90a): s8 wgmma fed by
// TMA, with two entry points and the pre-pass that lays a conv's operands
// out for it.
//
// Replaces mxnet_tpu/ops/quantization.py:_s8_conv (:190, XLA
// conv_general_dilated of int8 operands, preferred_element_type=int32) and
// :_s8_matmul (:174, XLA dot_general, the same), which the TPU runs on its
// MXU's int8 path, for every 2-D one-group conv and every GEMM that
// ops/quantization.py:_s8_route sends here (route "wgmma"); csrc/s8_gemm.cu
// (route "mma_s8") keeps the rest:
//   s8_wgmma_conv   — an implicit-GEMM convolution (stride, pad, dilation;
//                     one group) over x laid out NHWC with its channels
//                     padded to a multiple of 16 (cp) and the weight laid
//                     out (Cout, KH, KW, cp), flattened and zero-padded to
//                     kpad columns, both made by s8_wgmma_prep; int32 out,
//                     NCHW or NHWC; or with relu and a
//                     requantize in its epilogue, the counterpart of XLA
//                     fusing :_requant_epilogue (:207) into the conv's
//                     output on the TPU: int8 out under a calibrated range
//                     (the int32 never stored), or int32 out and its batch
//                     range folded into one word (csrc/requant.cuh's
//                     arithmetic, bitwise the plain chain);
//   s8_wgmma_matmul — x (M, K) row-major @ W (N, K)^T -> int32 (M, N).
// Both add an optional int32 bias per output channel in the epilogue and
// are exact: every product and sum is an integer, |sum| <= K * 127^2 <
// 2^31; the K order (r, s, ci here, ci, r, s in mxnet_tpu) changes nothing.
//
// Bound on the H100 SXM: ResNet-18 v1's 20 convs at N = 128 are 464 GOP
// (0.235 ms at 1,979 int8 TOP/s) and ~1.56 GB of int8 in and int32 out
// (0.47 ms at 3.35 TB/s), 80 % of it the int32 output: bytes bound the
// stack, and every 3x3 conv is 29.6 GOP whatever its shape.
//
// Design. 8-bit wgmma takes both operands K-major (no transpose flags), so
// the reduction axis, the channels, must be innermost in shared memory:
// - The pre-pass (s8_prep_kernel, one launch for both operands) writes x
//   as an NHWC int8 scratch of cp channels (zeros past C): an NCHW x whose
//   planes are a multiple of 4 pixels through a shared-memory tile of 128
//   pixels x 64 channels, read a word (4 pixels) a load, turned with byte
//   permutes and written along its rows; any other x a pixel's channels a
//   thread, byte by byte. A few-channel input (the stem: Cin 3) has its KW
//   taps along W folded into the channels instead (channel s C + ci of output
//   column q holds x[ci, q SW - PW + s DW]; the conv becomes KH x 1 with
//   K = KH x 32 = 224 against 49 x 16 padded channels), a thread gathering
//   one pixel's 32 channels. The weight goes into (Cout, kpad) rows of k =
//   tap * cp + channel, 16 bytes a thread. An NHWC x whose C is a multiple
//   of 16 on a 16-byte-aligned base is read in place.
// - A = the weight (wgmma's M: Cout, 64 rows a consumer warpgroup, 1 or 2
//   warpgroups a CTA); B = the output pixels (wgmma's N: 128 a CTA), so a
//   thread's accumulator pairs are consecutive pixels of one channel: in
//   NCHW they land next to each other, and a warp stores 8 channel rows of
//   32 contiguous bytes at a time.
// - B arrives by TMA in im2col mode: one load brings 128 output pixels x CB
//   channels of one tap, the box's corners set by the conv's pad, kernel
//   and dilation, its element strides by the conv's stride, the tap by the
//   load's offsets; TMA zero-fills the halo and the ragged end, and walks
//   across rows and images (every 7x7 tile spans three). A arrives by a
//   tiled TMA load of 64 x C rows by CB bytes, or, where one warpgroup
//   covers Cout and A fits in 72 KB (the stem, the 56x56 convs), once a
//   CTA: it then stays resident and the ring carries B alone. The GEMM
//   loads both by tiled TMA, rows past its end and K past its end reading
//   as zero.
// - CB, the channels a load brings, is 128, 64 or 32 (a swizzle of as many
//   bytes) where cp is a multiple of it, else 16 (no swizzle: 8-row x
//   16-byte core matrices), and then two loads of 16 channels fill one
//   32-byte K step. The channel box and the swizzle thus match the wgmma
//   descriptor's layout type.
// - Persistent: one CTA for each slot the card holds, output tiles dealt
//   round-robin (CTAs running together share a B tile). One producer warp
//   keeps a ring of up to 4 stages in flight across tiles (full/empty
//   mbarriers, as K3's), so it loads the next tile while the consumers
//   store this one; the consumers issue wgmma m64n128k32 s32.s8.s8 from
//   shared memory and keep one stage's products in flight.
// - Epilogue: bias added; NCHW with even planes as the fragment's 8-byte
//   pixel pairs (a pair never spans two images), odd planes through a
//   small buffer a warp (16 rows x 16 pixels) written with a lane a pixel
//   so consecutive lanes store consecutive words (odd planes' pixels one
//   word at a time from the fragment stored 7x7 planes at ~0.5 TB/s, and
//   the buffer costs the even planes 4-20 %); rows of `cols` (GEMM, NHWC)
//   straight from the fragment. Nothing past the last pixel or channel is
//   stored. The fused modes (Epi) take the same paths: relu, then int8
//   bytes (pairs, or a byte a lane) or the int32 with each thread's max
//   |fl(fl(v) a)| as float bits, one warp reduce and one atomicMax a warp
//   at the end. They run on one consumer warpgroup a CTA (dispatch_conv).
//
// What holds it back (PERF.md §6; tools/torch_k5_variants.py): the
// deep and stride-2 convs are bound by the tile traffic from L2 (the
// products left out change little), the int32 stores are not overlapped
// with the products (the consumers store a tile before starting the next;
// left out, they save up to 40 %), and the pre-pass is near a quarter of
// the stack's time. The next steps are an epilogue that overlaps the next
// tile's products (two consumer warpgroups taking tiles in turn, or TMA
// stores), TMA multicast of the B tile across the CTAs of a cluster that
// share it, and the producing requantize writing NHWC so the pre-pass
// goes.
//
// Shared memory: the ring, STAGES x (BM + 128) x KS bytes (KS = the K bytes
// a stage: CB, or 32 for CB = 16; B alone with A resident, plus A), at
// most 4 stages and ~110 KB, and 1 KB a consumer warp for the epilogue:
// two CTAs an SM. ptxas must report no spills (chip_smoke.py phase a).
//
// Prediction and the measured times: PERF.md §6.
#include "hopper.cuh"
#include "requant.cuh"

namespace {

constexpr int BN = 128;                 // B rows (pixels, x rows) a CTA
constexpr int PREP_THREADS = 256;
constexpr int RES_BUDGET = 72 * 1024;   // the largest resident A tile
constexpr int EPI_LD = 17;              // a warp's NCHW epilogue buffer: 16
constexpr int EPI_WORDS = 16 * EPI_LD;  //   rows x 16 pixels, padded

// C (1 or 2) consumer warpgroups (BM = 64 C rows of A) by CB channels a
// load, two CTAs an SM. RES: the whole of A (one tile of at most
// RES_BUDGET bytes) stays in shared memory, loaded once a CTA; the ring
// then holds B alone.
template <int C, int CB, bool RES = false>
struct Cfg {
  static constexpr int BM = 64 * C;
  static constexpr int NT = 128 * C + 32;           // + one producer warp
  static constexpr int BUDGET =
      110 * 1024 - (RES ? RES_BUDGET : 0);          // the ring's bytes
  static constexpr int G = CB < 32 ? 32 / CB : 1;   // loads of CB a stage
  static constexpr int KS = G * CB;                 // K bytes a stage
  static constexpr int KSTEPS = KS / 32;            // wgmma k32 a stage
  static constexpr int A_BYTES = RES ? 0 : BM * KS;
  static constexpr int B_BYTES = BN * KS;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int FIT = BUDGET / STAGE_BYTES;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT < 2 ? 2 : FIT;
  // the ring, 2 STAGES + 1 mbarriers, each consumer warp's epilogue
  // buffer, and 1 KB to align the tiles to the 1024-byte swizzle atom; RES
  // adds the A tile's bytes at launch
  static constexpr int SMEM = STAGES * STAGE_BYTES + (2 * STAGES + 1) * 8 +
                              4 * C * EPI_WORDS * 4 + 1024;
  // descriptor layout type and its 8-row stride
  static constexpr int LAYOUT = CB == 128 ? 1 : CB == 64 ? 2 : CB == 32 ? 3
                                                                         : 0;
  static constexpr int SBO = CB == 16 ? 128 : 8 * CB;
};

CUtensorMapSwizzle swizzle_of(int cb) {
  return cb == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : cb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
         : cb == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                    : CU_TENSOR_MAP_SWIZZLE_NONE;
}

// The channels (K bytes) a load brings for cp channels (or a GEMM's K).
int chunk_of(int cp) {
  return cp % 128 == 0 ? 128 : cp % 64 == 0 ? 64 : cp % 32 == 0 ? 32 : 16;
}

// The epilogue's modes (a conv's; the GEMM stores int32): EPI_INT32 stores
// the int32 sum; EPI_REQUANT requantizes it under a calibrated range
// (csrc/requant.cuh, via_fp32) and stores int8, so the int32 never reaches
// memory; EPI_RANGE stores the int32 and folds its batch range into one
// device word. The two fused modes take relu first where ep.relu is set.
enum { EPI_INT32 = 0, EPI_REQUANT = 1, EPI_RANGE = 2 };

struct Epi {
  const float* real_in;   // the int32 grid's range (EPI_REQUANT, EPI_RANGE)
  const float* out_min;   // the calibrated output range (EPI_REQUANT)
  const float* out_max;
  float* lo;              // written with -real_out, real_out (EPI_REQUANT)
  float* hi;
  unsigned* amax;         // the batch range's float bits (EPI_RANGE),
                          //   zeroed by the entry point
  int relu;
};

struct Geom {
  int rows;          // B rows: output pixels (conv) or x rows (GEMM)
  int cols;          // A rows: output channels (conv) or W rows (GEMM)
  int n_iter;        // stages of K
  int chunks;        // loads of CB with data; the rest of K reads zero
  int cpt;           // loads a tap (conv)
  int kw, dh, dw, sh, sw, ph, pw, ho, wo;   // conv geometry
  int nchw;          // out: NCHW planes (1) or rows of `cols` (0)
};

// Accumulator fragment of wgmma m64n128 s32 (as f32, hopper.cuh), for the
// thread at lane (g = lane / 4, c = lane % 4) of warp w in its warpgroup:
// register 4j + e holds A row 16w + g + 8 (e / 2), B row 8j + 2c + e % 2.
//
// Persistent: CTA b takes output tiles b, b + gridDim.x, ..., tile t being
// B tile t / a_tiles and A tile t % a_tiles (CTAs running together share
// a B tile, read once from HBM). The ring runs on across tiles, so the
// producer loads the next tile while the consumers store this one.
template <int C, int CB, bool CONV, bool RES, int EPI>
__global__ void __launch_bounds__(Cfg<C, CB>::NT, 2)
s8_wgmma_kernel(const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap ta,
                const int* __restrict__ bias, void* __restrict__ out_v,
                const Geom gm, const Epi ep) {
  using K = Cfg<C, CB, RES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // RES: A's chunk kc at a_all + kc * BM * CB, the ring after it
  uint8_t* a_all = tiles;
  const int a_all_bytes = RES ? gm.n_iter * K::G * K::BM * CB : 0;
  tiles += a_all_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles +
                                               K::STAGES * K::STAGE_BYTES);
  uint64_t* empty = full + K::STAGES;
  uint64_t* a_ready = empty + K::STAGES;
  uint32_t* epi = reinterpret_cast<uint32_t*>(a_ready + 1);
  const int a_tiles = (gm.cols + K::BM - 1) / K::BM;
  const int n_tiles = (gm.rows + BN - 1) / BN * a_tiles;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < K::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C);   // one arrival per consumer warp
    }
    mbar_init(a_ready, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4 * C) {
    // ---- producer: one thread keeps the TMA loads in flight
    if (lane != 0) return;
    tma_prefetch(&ta);
    tma_prefetch(&tb);
    if constexpr (RES) {
      mbar_expect_tx(a_ready, a_all_bytes);
      for (int kc = 0; kc < gm.n_iter * K::G; ++kc)
        tma_load_2d(a_all + kc * K::BM * CB, &ta, a_ready, kc * CB, 0);
    }
    int k = 0;   // the ring's running count of stages
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int n0 = tile / a_tiles * BN, m0 = tile % a_tiles * K::BM;
      int img = 0, hs = 0, ws = 0;
      if constexpr (CONV) {
        // the input pixel of tap (0, 0) for the tile's first output pixel
        const int hw = gm.ho * gm.wo;
        img = n0 / hw;
        const int rem = n0 - img * hw, p = rem / gm.wo, q = rem - p * gm.wo;
        hs = p * gm.sh - gm.ph;
        ws = q * gm.sw - gm.pw;
      }
      for (int it = 0; it < gm.n_iter; ++it, ++k) {
        const int s = k % K::STAGES, use = k / K::STAGES;
        if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
        uint8_t* a = tiles + s * K::STAGE_BYTES;
        uint8_t* b = a + K::A_BYTES;
        mbar_expect_tx(&full[s], K::STAGE_BYTES);
#pragma unroll
        for (int g = 0; g < K::G; ++g) {
          const int kc = it * K::G + g;
          if constexpr (!RES)
            tma_load_2d(a + g * K::BM * CB, &ta, &full[s], kc * CB, m0);
          if constexpr (CONV) {
            // a load past the last tap reads tap 0: its weight is zero
            const int tap = kc < gm.chunks ? kc / gm.cpt : 0;
            const int c0 = kc < gm.chunks ? (kc - tap * gm.cpt) * CB : 0;
            const int r = tap / gm.kw, q = tap - r * gm.kw;
            tma_load_im2col(b + g * BN * CB, &tb, &full[s], c0, ws, hs, img,
                            uint16_t(q * gm.dw), uint16_t(r * gm.dh));
          } else {
            tma_load_2d(b + g * BN * CB, &tb, &full[s], kc * CB, n0);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns A rows m0 + 64 wg .. m0 + 64 wg + 63
  const int wg = warp / 4, w = warp % 4, g = lane / 4, c = lane % 4;
  const int hw = CONV ? gm.ho * gm.wo : 1;
  int* out = static_cast<int*>(out_v);
  int8_t* out8 = static_cast<int8_t*>(out_v);
  rq::Scale sc{};
  float step = 0.f;       // EPI_RANGE: real_in / 2147483647
  uint32_t range = 0u;    // EPI_RANGE: the thread's max |fl(fl(v) step)| bits
  if constexpr (EPI == EPI_REQUANT) {
    const float rout = rq::calibrated(ep.out_min, ep.out_max);
    sc = rq::make_scale<0>(*ep.real_in, rout);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      *ep.lo = -rout;
      *ep.hi = rout;
    }
  } else if constexpr (EPI == EPI_RANGE) {
    step = rq::in_step(*ep.real_in);
  }
  // one output value: the sum plus the bias, relu'd where a fused mode
  // asks (the int32 epilogue takes none, so its code is the plain store's)
  const auto value = [&](uint32_t a, int add) {
    const int v = int(a) + add;
    if constexpr (EPI == EPI_INT32) {
      return v;
    } else {
      return ep.relu && v < 0 ? 0 : v;
    }
  };
  // stores v at element o of the output, as the mode says
  const auto store = [&](long long o, int v) {
    if constexpr (EPI == EPI_REQUANT) {
      out8[o] = rq::requant<0>(v, sc);
    } else {
      out[o] = v;
      if constexpr (EPI == EPI_RANGE) range = max(range, rq::abs_bits(v, step));
    }
  };
  // stores the pair v0, v1 at elements o, o + 1 (o even: int8 pairs
  // 2-byte aligned, int32 pairs 8-byte aligned)
  const auto store2 = [&](long long o, int v0, int v1) {
    if constexpr (EPI == EPI_REQUANT) {
      *reinterpret_cast<char2*>(out8 + o) =
          make_char2(rq::requant<0>(v0, sc), rq::requant<0>(v1, sc));
    } else {
      *reinterpret_cast<int2*>(out + o) = make_int2(v0, v1);
      if constexpr (EPI == EPI_RANGE)
        range = max(range, max(rq::abs_bits(v0, step),
                               rq::abs_bits(v1, step)));
    }
  };
  uint32_t acc[BN / 2];
  if constexpr (RES) mbar_wait(a_ready, 0);
  int k = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n0 = tile / a_tiles * BN, m0 = tile % a_tiles * K::BM;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0u;
    for (int it = 0; it < gm.n_iter; ++it, ++k) {
      const int s = k % K::STAGES;
      mbar_wait(&full[s], (k / K::STAGES) & 1);
      const uint8_t* a = (RES ? a_all + it * K::G * K::BM * CB
                              : tiles + s * K::STAGE_BYTES) +
                         wg * 64 * CB;
      const uint8_t* b = tiles + s * K::STAGE_BYTES + K::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < K::KSTEPS; ++kk) {
        // unswizzled (CB = 16): the step's second 16 bytes are the stage's
        // second load, a whole tile further on (the LBO)
        const uint32_t lbo_a = CB == 16 ? K::BM * 16 : 16;
        const uint32_t lbo_b = CB == 16 ? BN * 16 : 16;
        wgmma_s8<BN>(acc, smem_desc(a + 32 * kk, lbo_a, K::SBO, K::LAYOUT),
                     smem_desc(b + 32 * kk, lbo_b, K::SBO, K::LAYOUT));
      }
      wgmma_commit();
      // the previous stage's products are done: hand its buffers back
      wgmma_wait<1>();
      if (it > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(k - 1) % K::STAGES]);
      }
    }
    wgmma_wait<0>();
    pin<BN / 2>(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(k - 1) % K::STAGES]);

    // ---- epilogue
    const int co0 = m0 + 64 * wg + 16 * w;   // the warp's 16 output rows
    int add[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      add[h] = bias != nullptr && co0 + g + 8 * h < gm.cols
                   ? bias[co0 + g + 8 * h]
                   : 0;
    if (gm.nchw && hw % 2 == 0) {
      // even planes: the fragment's pixel pairs, never across two images,
      // walking the planes (image img, position p)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = co0 + g + 8 * h;
        if (co >= gm.cols) continue;
        int img = (n0 + 2 * c) / hw, p = n0 + 2 * c - img * hw;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          if (n0 + 8 * j + 2 * c < gm.rows)
            store2(((long long)img * gm.cols + co) * hw + p,
                   value(acc[4 * j + 2 * h], add[h]),
                   value(acc[4 * j + 2 * h + 1], add[h]));
          for (p += 8; p >= hw; p -= hw) ++img;
        }
      }
    } else if (gm.nchw) {
      // odd planes: 16 pixels at a time through the warp's buffer, then
      // written with a lane a pixel (two rows a pass), consecutive lanes
      // consecutive elements of a plane
      uint32_t* buf = epi + warp * EPI_WORDS;
#pragma unroll
      for (int q = 0; q < BN / 16; ++q) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              buf[(g + 8 * h) * EPI_LD + 8 * jj + 2 * c + e] =
                  uint32_t(value(acc[4 * (2 * q + jj) + 2 * h + e], add[h]));
        __syncwarp();
        const int px = n0 + 16 * q + (lane & 15);
        if (px < gm.rows) {
          const int img = px / hw;
          const long long dst =
              (long long)img * gm.cols * hw + (px - img * hw);
#pragma unroll 1
          for (int i = 0; i < 8; ++i) {
            const int r = 2 * i + (lane >> 4);
            if (co0 + r < gm.cols)
              store(dst + (long long)(co0 + r) * hw,
                    int(buf[r * EPI_LD + (lane & 15)]));
          }
        }
        __syncwarp();
      }
    } else {
      // rows of `cols` (NHWC, GEMM) straight from the fragment
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = co0 + g + 8 * h;
        if (co >= gm.cols) continue;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int px = n0 + 8 * j + 2 * c;
          if (px < gm.rows)
            store((long long)px * gm.cols + co,
                  value(acc[4 * j + 2 * h], add[h]));
          if (px + 1 < gm.rows)
            store((long long)(px + 1) * gm.cols + co,
                  value(acc[4 * j + 2 * h + 1], add[h]));
        }
      }
    }
  }
  if constexpr (EPI == EPI_RANGE) rq::fold_warp(range, ep.amax);
}

// The pre-pass, one launch for both operands.
// x (any element strides) -> xp, rows of cp channels, one row a pixel
// (n, y, q) of n x h x wq: channel j < fold * c of row (n, y, q) is x[n,
// j % c, y, q * fs - fp + (j / c) * fd] (zero outside x), the rest zero.
// Unfolded (fold 1, fs 1, fp 0, fd 0, wq = w) that is x as NHWC with its
// channels padded; folded (fold = kw) the conv's kw taps along W become
// channels (s, ci) of each output column q, and the conv becomes kh x 1.
// w (any element strides, (cout, c, kh, kw)) -> wp (cout, kpad): column k
// = t * cp + j of tap t of the kh x kw' kernel (kw' = kw / fold) is w[co,
// j % c, t / kw', t % kw' + j / c] for j < fold * c, zero past that and
// past the last tap.
struct Prep {
  const int8_t* x;
  long long sxn, sxc, sxh, sxw;
  int n, c, h, w, wq;
  int fold, fs, fp, fd;
  const int8_t* wt;
  long long swo, swi, swh, sww;
  int cout, kh, kw;
  int cp, kpad;
  int8_t* xp;
  int8_t* wp;
  int quad;          // x NCHW-dense, planes of 4k pixels, 4-byte aligned
  unsigned x_blocks;
};

// xp's tile b with quad (x NCHW-dense, unfolded, planes a multiple of 4
// pixels, 4-byte aligned): 128 pixels x 64 channels. Thread (quad l, group
// g) loads 8 words, channels 8g .. 8g + 7 of pixels 4l .. 4l + 3 (a warp:
// 128 consecutive bytes of a channel row), turns each 4 x 4 block of bytes
// with byte permutes into shared memory (pixel 4l + e at row 33 e + l, 17
// words a row: no bank conflicts), then the block writes the tile's rows
// 16 bytes a thread, consecutive threads consecutive bytes (whole lines
// for cp = 64).
constexpr int LDW = 17;
__device__ __forceinline__ void prep_x_tile(const Prep& p, long long b,
                                            uint32_t* tile) {
  const long long pixels = (long long)p.n * p.h * p.w;
  const long long plane = (long long)p.h * p.w;
  const int blocks_c = (p.cp + 63) / 64;
  const long long q0 = b / blocks_c * 128;
  const int c0 = int(b % blocks_c) * 64;
  const int l = threadIdx.x % 32, g = threadIdx.x / 32;
  const long long q = q0 + 4 * l;
  uint32_t w[8];
  if (q < pixels) {
    const long long img = q / plane;
    const int8_t* src = p.x + img * p.sxn + (q - img * plane);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + 8 * g + i;
      w[i] = c < p.c ? *reinterpret_cast<const uint32_t*>(src + c * p.sxc)
                     : 0u;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = 0u;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t* v = w + 4 * h;   // channels 8g + 4h .. + 3, 4 pixels
    const uint32_t lo01 = __byte_perm(v[0], v[1], 0x5140);
    const uint32_t lo23 = __byte_perm(v[2], v[3], 0x5140);
    const uint32_t hi01 = __byte_perm(v[0], v[1], 0x7362);
    const uint32_t hi23 = __byte_perm(v[2], v[3], 0x7362);
    const uint32_t o[4] = {__byte_perm(lo01, lo23, 0x5410),
                           __byte_perm(lo01, lo23, 0x7632),
                           __byte_perm(hi01, hi23, 0x5410),
                           __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
    for (int e = 0; e < 4; ++e) tile[(33 * e + l) * LDW + 2 * g + h] = o[e];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = threadIdx.x + PREP_THREADS * j;
    const int px = i / 4, k = i % 4;
    if (q0 + px >= pixels || c0 + 16 * k >= p.cp) continue;
    const uint32_t* r = tile + (33 * (px % 4) + px / 4) * LDW + 4 * k;
    *reinterpret_cast<uint4*>(p.xp + (q0 + px) * p.cp + c0 + 16 * k) =
        make_uint4(r[0], r[1], r[2], r[3]);
  }
}

// xp's piece t otherwise (a fold, a plane off a multiple of 4 pixels, an
// NHWC x): a thread gathers PIECE channels (32 where cp allows, so whole
// 32-byte sectors, else 16) of one output pixel byte by byte, consecutive
// threads consecutive pixels of the same piece (a warp's loads: 32
// consecutive bytes of an NCHW channel row; a stride-2 fold's, 64).
template <int PIECE>
__device__ __forceinline__ void prep_x_gather(const Prep& p, long long t) {
  constexpr int W = PIECE / 4;   // words a pixel's piece
  const long long pixels = (long long)p.n * p.h * p.wq;
  if (t >= pixels * (p.cp / PIECE)) return;
  const long long q = t % pixels, plane = (long long)p.h * p.wq;
  const int jb = int(t / pixels) * PIECE;
  const long long img = q / plane, rem = q - img * plane;
  const int y = int(rem / p.wq), xq = int(rem - (long long)y * p.wq);
  const int8_t* row = p.x + img * p.sxn + y * p.sxh;
  // channel jb + i is x's channel ci of tap s (s = 0 unfolded: fs 1, fp
  // 0, fd 0), stepped without a division a byte
  int s = jb / p.c, ci = jb - s * p.c;
  const int valid = p.fold * p.c;
  uint32_t word[W];
#pragma unroll
  for (int k = 0; k < W; ++k) word[k] = 0u;
#pragma unroll
  for (int i = 0; i < PIECE; ++i) {
    const int xs = xq * p.fs - p.fp + s * p.fd;
    if (jb + i < valid && xs >= 0 && xs < p.w)
      word[i >> 2] |= uint32_t(uint8_t(row[ci * p.sxc + xs * p.sxw]))
                      << (8 * (i & 3));
    if (++ci == p.c) {
      ci = 0;
      ++s;
    }
  }
#pragma unroll
  for (int k = 0; k < W; k += 4)
    *reinterpret_cast<uint4*>(p.xp + q * p.cp + jb + 4 * k) =
        make_uint4(word[k], word[k + 1], word[k + 2], word[k + 3]);
}

// Blocks [0, x_blocks): xp (prep_x_tile with quad, else prep_x_gather).
// The rest: wp, 16 bytes a thread gathered byte by byte.
__global__ void __launch_bounds__(PREP_THREADS)
s8_prep_kernel(const Prep p) {
  __shared__ uint32_t tile[4 * 33 * LDW];
  if (blockIdx.x < p.x_blocks) {
    const long long t = (long long)blockIdx.x * PREP_THREADS + threadIdx.x;
    if (p.quad)
      prep_x_tile(p, blockIdx.x, tile);
    else if (p.cp % 32 == 0)
      prep_x_gather<32>(p, t);
    else
      prep_x_gather<16>(p, t);
    return;
  }
  const long long t =
      (long long)(blockIdx.x - p.x_blocks) * PREP_THREADS + threadIdx.x;
  const int per_row = p.kpad / 16;
  if (t >= (long long)p.cout * per_row) return;
  const int co = int(t / per_row), k0 = int(t % per_row) * 16;
  const int kw1 = p.kw / p.fold, tap = k0 / p.cp, j0 = k0 - tap * p.cp;
  const int r = tap / kw1;
  // channel j0 + i of tap (r, s0) is the weight's channel ci of its tap
  // (r, s), stepped without a division a byte
  int s = tap - r * kw1 + j0 / p.c, ci = j0 % p.c;
  uint32_t word[4] = {0u, 0u, 0u, 0u};
  if (tap < p.kh * kw1) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (j0 + i >= p.fold * p.c) break;
      const int8_t v = p.wt[co * p.swo + ci * p.swi + r * p.swh + s * p.sww];
      word[i >> 2] |= uint32_t(uint8_t(v)) << (8 * (i & 3));
      if (++ci == p.c) {
        ci = 0;
        ++s;
      }
    }
  }
  *reinterpret_cast<uint4*>(p.wp + (long long)co * p.kpad + k0) =
      make_uint4(word[0], word[1], word[2], word[3]);
}

template <int C, int CB, bool CONV, bool RES, int EPI>
int launch(const CUtensorMap& tb, const CUtensorMap& ta, const int* bias,
           void* out, const Geom& gm, const Epi& ep, cudaStream_t stream) {
  using K = Cfg<C, CB, RES>;
  auto kernel = s8_wgmma_kernel<C, CB, CONV, RES, EPI>;
  static unsigned long long attr_set = 0;   // one bit per device
  const int smem =
      K::SMEM + (RES ? gm.n_iter * K::G * K::BM * CB : 0);
  int err, dev = 0, sms = 0, per_sm = 0;
  if ((err = allow_smem(kernel, K::SMEM + (RES ? RES_BUDGET : 0),
                        attr_set)) ||
      (err = int(cudaGetDevice(&dev))) ||
      (err = int(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev))) ||
      (err = int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, K::NT, smem))))
    return err;
  if (per_sm < 1) return ERR_SHAPE;
  // one CTA for each slot the card holds, tiles dealt round-robin
  const long long n_tiles = (long long)((gm.rows + BN - 1) / BN) *
                            ((gm.cols + K::BM - 1) / K::BM);
  if (n_tiles >= (1LL << 31)) return ERR_SHAPE;
  const int grid = int(n_tiles < sms * per_sm ? n_tiles : sms * per_sm);
  kernel<<<grid, K::NT, smem, stream>>>(tb, ta, bias, out, gm, ep);
  return int(cudaGetLastError());
}

template <int C, bool CONV, bool RES = false, int EPI = EPI_INT32>
int dispatch_cb(int cb, const CUtensorMap& tb, const CUtensorMap& ta,
                const int* bias, void* out, const Geom& gm, const Epi& ep,
                cudaStream_t s) {
#define S8_LAUNCH(CB_) \
  launch<C, CB_, CONV, RES, EPI>(tb, ta, bias, out, gm, ep, s)
  switch (cb) {
    case 128: return S8_LAUNCH(128);
    case 64: return S8_LAUNCH(64);
    case 32: return S8_LAUNCH(32);
    case 16: return S8_LAUNCH(16);
    default: return ERR_SHAPE;
  }
#undef S8_LAUNCH
}

// The conv's kernel for wgs warpgroups and the epilogue mode EPI: one
// warpgroup covering every output channel keeps A resident when it fits.
// The fused modes run on one warpgroup a CTA: with two they do not fit the
// 96 registers a thread that two CTAs an SM leave (the int32 epilogue
// takes 94), and spill; the requantize's division calls its slow path as
// a subroutine.
template <int EPI>
int dispatch_conv(int cb, int wgs, bool resident, const CUtensorMap& tb,
                  const CUtensorMap& ta, const int* bias, void* out,
                  const Geom& gm, const Epi& ep, cudaStream_t s) {
  if (resident)
    return dispatch_cb<1, true, true, EPI>(cb, tb, ta, bias, out, gm, ep, s);
  if constexpr (EPI == EPI_INT32) {
    if (wgs == 2)
      return dispatch_cb<2, true, false, EPI>(cb, tb, ta, bias, out, gm, ep,
                                              s);
  }
  return dispatch_cb<1, true, false, EPI>(cb, tb, ta, bias, out, gm, ep, s);
}

// Stages of K for `chunks` loads of cb bytes.
int stages_of(int chunks, int cb) {
  const int g = cb < 32 ? 32 / cb : 1;
  return (chunks + g - 1) / g;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// The pre-pass (s8_prep_kernel, whose comment gives the layouts): x
// (element strides sxn, sxc, sxh, sxw over (n, c, h, w); null skips it)
// -> xp (n, h, wq, cp), and w (element strides swo, swi, swh, sww over
// (cout, c, kh, kw)) -> wp (cout, kpad); fold 1 or kw with its stride fs,
// pad fp and dilation fd along W; cp a multiple of 16 >= fold * c, kpad a
// multiple of 16 >= kh * (kw / fold) * cp; xp and wp 16-byte aligned.
// Launches one kernel on `stream` and returns a cudaError_t code or
// ERR_SHAPE.
extern "C" int s8_wgmma_prep(const void* x, long long sxn, long long sxc,
                             long long sxh, long long sxw, int n, int c,
                             int h, int w, int wq, int fold, int fs, int fp,
                             int fd, const void* wt, long long swo,
                             long long swi, long long swh, long long sww,
                             int cout, int kh, int kw, int cp, int kpad,
                             void* xp, void* wp, void* stream) {
  if (n < 1 || c < 1 || h < 1 || w < 1 || wq < 1 || cout < 1 || kh < 1 ||
      kw < 1 || fold < 1 || (fold != 1 && fold != kw) || cp % 16 ||
      cp < fold * c || kpad % 16 || kpad < kh * (kw / fold) * cp ||
      !aligned16(wp) || (x != nullptr && !aligned16(xp)))
    return ERR_SHAPE;
  const long long pixels = x != nullptr ? (long long)n * h * wq : 0;
  const bool quad = fold == 1 && sxw == 1 && sxh == w && (h * w) % 4 == 0 &&
                    sxc % 4 == 0 && sxn % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(x) & 3) == 0;
  const long long xb =
      quad ? (pixels + 127) / 128 * ((cp + 63) / 64)
           : (pixels * (cp / (cp % 32 ? 16 : 32)) + PREP_THREADS - 1) /
                 PREP_THREADS;
  const long long wb =
      ((long long)cout * (kpad / 16) + PREP_THREADS - 1) / PREP_THREADS;
  if (xb + wb >= (1LL << 31)) return ERR_SHAPE;
  Prep p{static_cast<const int8_t*>(x), sxn, sxc, sxh, sxw, n, c, h, w, wq,
         fold, fs, fp, fd, static_cast<const int8_t*>(wt), swo, swi, swh,
         sww, cout, kh, kw, cp, kpad, static_cast<int8_t*>(xp),
         static_cast<int8_t*>(wp), quad ? 1 : 0, unsigned(xb)};
  s8_prep_kernel<<<unsigned(xb + wb), PREP_THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}

// The conv on the pre-pass's operands: xp (n, h, w, cp) and wp (cout,
// kpad) int8 as s8_wgmma_prep lays them out (kpad exactly the stages' K:
// ops/quantization.py:_s8_pack), a conv of kh x kw taps (a folded one's
// kw, stride, pad and dilation along W are 1, 1, 0, 1); bias int32
// (cout,) or null; out int32 (n, cout, ho, wo) with nchw, else (n, ho, wo,
// cout); wgs consumer warpgroups a CTA
// (1 or 2: 64 wgs output channels). epi: 0 stores int32 out; 1 stores
// int8 out, requantized under real_in and the calibrated (out_min,
// out_max), and writes (-real_out, real_out) to lo and hi; 2 stores int32
// out and the float bits of its batch range max |fl(fl(v) real_in /
// 2147483647)| to amax (zeroed here first); relu (0 or 1) before either
// (epi 0 takes none); epi 1 and 2 on wgs 1 only.
// real_in, out_min, out_max float32 scalars on the device (null where the
// mode reads none). Launches on `stream`, never synchronises, and returns
// 0, a cudaError_t, or one of hopper.cuh's ERR_* codes (ERR_SHAPE: a
// geometry TMA's im2col mode does not take, or a mode's scalars missing).
extern "C" int s8_wgmma_conv(const void* xp, const void* wp, const void* bias,
                             void* out, int n, int h, int w, int cp,
                             int cout, int kh, int kw, int sh, int sw,
                             int ph, int pw, int dh, int dw, int ho, int wo,
                             int kpad, int nchw, int wgs, int epi, int relu,
                             const void* real_in, const void* out_min,
                             const void* out_max, void* lo, void* hi,
                             void* amax, void* stream) {
  if (n < 1 || h < 1 || w < 1 || cp < 16 || cp % 16 || cout < 1 || kh < 1 ||
      kw < 1 || sh < 1 || sh > 8 || sw < 1 || sw > 8 || ph < 0 || pw < 0 ||
      dh < 1 || dw < 1 || ho < 1 || wo < 1 || !aligned16(xp) ||
      !aligned16(wp) || (wgs != 1 && wgs != 2) || epi < 0 || epi > 2 ||
      (epi != 0 && wgs != 1) || (epi == 0 && relu) ||
      (epi != 0 && real_in == nullptr) ||
      (epi == 1 && (out_min == nullptr || out_max == nullptr ||
                    lo == nullptr || hi == nullptr)) ||
      (epi == 2 && amax == nullptr))
    return ERR_SHAPE;
  const int lw = -pw, lh = -ph, uw = pw - (kw - 1) * dw,
            uh = ph - (kh - 1) * dh;
  if (lw < -128 || lh < -128 || uw < -128 || uw > 127 || uh < -128 ||
      uh > 127 || (kw - 1) * dw > 127 || (kh - 1) * dh > 127 ||
      (w + uw - lw - 1) / sw + 1 != wo || (h + uh - lh - 1) / sh + 1 != ho)
    return ERR_SHAPE;
  const long long rows = (long long)n * ho * wo;
  const int cb = chunk_of(cp), cpt = cp / cb;
  const long long chunks = (long long)kh * kw * cpt;
  if (rows >= (1LL << 31) || chunks * cb >= (1LL << 31) ||
      (long long)stages_of(int(chunks), cb) * (cb < 32 ? 32 : cb) != kpad)
    return ERR_SHAPE;
  CUtensorMap tb, ta;
  int err;
  if ((err = make_im2col_map(&tb, xp, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, n, h,
                             w, cp, lw, lh, uw, uh, sw, sh, cb, BN,
                             swizzle_of(cb))) ||
      (err = make_tiled_2d(&ta, wp, CU_TENSOR_MAP_DATA_TYPE_UINT8, kpad, cout,
                           kpad, cb, 64 * wgs, swizzle_of(cb))))
    return err;
  const Geom gm{int(rows), cout, stages_of(int(chunks), cb), int(chunks),
                cpt, kw, dh, dw, sh, sw, ph, pw, ho, wo, nchw ? 1 : 0};
  const int* b = static_cast<const int*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Epi ep{static_cast<const float*>(real_in),
               static_cast<const float*>(out_min),
               static_cast<const float*>(out_max), static_cast<float*>(lo),
               static_cast<float*>(hi), static_cast<unsigned*>(amax),
               relu ? 1 : 0};
  const bool res = wgs == 1 && cout <= 64 && 64LL * kpad <= RES_BUDGET;
  switch (epi) {
    case EPI_REQUANT:
      return dispatch_conv<EPI_REQUANT>(cb, wgs, res, tb, ta, b, out, gm, ep,
                                        st);
    case EPI_RANGE:
      if ((err = int(cudaMemsetAsync(amax, 0, sizeof(unsigned), st))))
        return err;
      return dispatch_conv<EPI_RANGE>(cb, wgs, res, tb, ta, b, out, gm, ep,
                                      st);
    default:
      return dispatch_conv<EPI_INT32>(cb, wgs, res, tb, ta, b, out, gm, ep,
                                      st);
  }
}

// x int8 (m, k) and w int8 (n, k), row-major, contiguous, 16-byte-aligned
// bases, k a multiple of 16; bias int32 (n,) or null; out int32 (m, n).
// Returns a cudaError_t code or one of hopper.cuh's ERR_* codes.
extern "C" int s8_wgmma_matmul(const void* x, const void* w, const void* bias,
                               void* out, int m, int n, int k, void* stream) {
  if (m < 1 || n < 1 || k < 16 || k % 16 || !aligned16(x) || !aligned16(w))
    return ERR_SHAPE;
  const int cb = chunk_of(k);
  CUtensorMap tb, ta;
  int err;
  if ((err = make_tiled_2d(&tb, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, k, m, k, cb,
                           BN, swizzle_of(cb))) ||
      (err = make_tiled_2d(&ta, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, k, n, k, cb,
                           128, swizzle_of(cb))))
    return err;
  const Geom gm{m, n, stages_of(k / cb, cb), k / cb, 0, 1, 1, 1, 1, 1,
                0, 0, 1, 1, 0};
  return dispatch_cb<2, false>(cb, tb, ta, static_cast<const int*>(bias), out,
                               gm, Epi{}, static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory of a CTA of wgs warpgroups with loads of cb
// bytes (its ring and barriers; a resident A tile adds its own bytes), or
// -1.
extern "C" int s8_wgmma_smem_bytes(int wgs, int cb) {
  const int i = cb == 16 ? 0 : cb == 32 ? 1 : cb == 64 ? 2 : cb == 128 ? 3
                                                                     : -1;
  static const int bytes[2][4] = {
      {Cfg<1, 16>::SMEM, Cfg<1, 32>::SMEM, Cfg<1, 64>::SMEM,
       Cfg<1, 128>::SMEM},
      {Cfg<2, 16>::SMEM, Cfg<2, 32>::SMEM, Cfg<2, 64>::SMEM,
       Cfg<2, 128>::SMEM}};
  return (wgs == 1 || wgs == 2) && i >= 0 ? bytes[wgs - 1][i] : -1;
}

extern "C" const char* s8_gemm_wgmma_error_string(int err) {
  switch (err) {
    case ERR_NO_ENCODER:
      return "cuTensorMapEncodeIm2col or cuTensorMapEncodeTiled is not "
             "available from the driver";
    case ERR_ENCODE:
      return "the driver refused a tensor map (strides or base address not "
             "16-byte aligned, or an im2col corner out of range?)";
    case ERR_SHAPE:
      return "shape, stride, pad, dilation or alignment the wgmma kernel "
             "does not take";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}
