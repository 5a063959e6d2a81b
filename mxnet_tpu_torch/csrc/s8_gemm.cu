// K5's int8 GEMM core for Hopper (sm_90a): int8 x int8 -> int32 on the
// tensor cores, with two entry points.
//
// Replaces mxnet_tpu/ops/quantization.py:_s8_conv (XLA conv_general_dilated
// of int8 operands, preferred_element_type=int32) and :_s8_matmul (XLA
// dot_general, the same), which the TPU runs on its MXU's int8 path:
//   s8_conv   — an implicit-GEMM convolution over NCHW int8 data and OIHW
//               int8 weights (stride, pad, dilation; one group), written as
//               int32 NCHW: M = N*Ho*Wo rows, Cout columns, K = Cin*KH*KW
//               with k = (ci*KH + r)*KW + s, so the weight is its own (Cout,
//               K) row-major B operand;
//   s8_matmul — x (M, K) row-major @ W (N, K)^T -> int32 (M, N).
// Both add an optional int32 bias per output column in the epilogue (the
// quantized op's rescaled bias, an exact integer add as in mxnet_tpu) and
// are exact: every product and sum is an integer, |sum| <= K*127^2.
//
// Bound on the H100 SXM: at ResNet-18 v1's shapes the products are 464 GOP
// at N=128 (0.23 ms at 1,979 int8 TOP/s), while the int32 output alone is
// ~1.27 GB (0.38 ms at 3.35 TB/s): bytes bound the whole conv stack, and
// most of those bytes are this kernel's int32 writes. The design is the
// simple one that is right: 64 x 64 output tiles, K in steps of 32 staged
// in shared memory, four warps each on a 32 x 32 quarter with
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32; the next K step is
// loaded into registers while the tensor cores work on this one, and two
// shared buffers let one __syncthreads a step suffice. A's rows are
// gathered byte by byte (im2col on the fly; the zero padding, the K tail
// and the ragged M edge are zeros in the loads, never copies on the host).
// wgmma on s8, TMA loads and the requantize fused into this epilogue are
// the redesign (ROADMAP Queue 2).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output rows (GEMM M) a CTA
constexpr int BN = 64;          // output columns (Cout / N) a CTA
constexpr int BK = 32;          // K a step: one m16n8k32
constexpr int THREADS = 128;    // four warps, 2 (M) x 2 (N), 32 x 32 each
constexpr int LDS = BK + 16;    // a shared row of 48 bytes: the fragment
                                // loads of 8 rows x 4 lanes hit 32 banks

struct Conv {                   // the implicit A operand of s8_conv
  const int8_t* x;
  int C, H, W, KH, KW, SH, SW, PH, PW, DH, DW, Ho, Wo;
};

// Sixteen K-consecutive bytes of one row, packed little-endian into four
// words (byte j of the row at bits 8*(j%4) of word j/4).
struct Pack {
  uint32_t w[4];
};

__device__ __forceinline__ void put(Pack& p, int j, int8_t v) {
  p.w[j >> 2] |= uint32_t(uint8_t(v)) << (8 * (j & 3));
}

// A row of a row-major (rows, K) int8 matrix: bytes k0 .. k0+15, zero past
// K or past the last row.
__device__ __forceinline__ Pack load_rows(const int8_t* a, int rows, int K,
                                          int row, int k0, bool vec) {
  Pack p = {{0u, 0u, 0u, 0u}};
  if (row >= rows) return p;
  const int8_t* src = a + (long long)row * K + k0;
  if (vec && k0 + 16 <= K) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    p.w[0] = v.x; p.w[1] = v.y; p.w[2] = v.z; p.w[3] = v.w;
    return p;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (k0 + j < K) put(p, j, src[j]);
  return p;
}

// Row m of the im2col matrix of x (NCHW), bytes k0 .. k0+15.
struct ConvRow {
  const int8_t* base;   // x + n_img*C*H*W
  int h0, w0;           // ho*SH - PH, wo*SW - PW
  bool valid;
};

__device__ __forceinline__ ConvRow conv_row(const Conv& g, int M, int m) {
  ConvRow r;
  r.valid = m < M;
  const int hw = g.Ho * g.Wo;
  const int n = r.valid ? m / hw : 0;
  const int p = r.valid ? m - n * hw : 0;
  const int ho = p / g.Wo, wo = p - ho * g.Wo;
  r.base = g.x + (long long)n * g.C * g.H * g.W;
  r.h0 = ho * g.SH - g.PH;
  r.w0 = wo * g.SW - g.PW;
  return r;
}

__device__ __forceinline__ Pack load_conv(const Conv& g, const ConvRow& r,
                                          int K, int k0) {
  Pack p = {{0u, 0u, 0u, 0u}};
  if (!r.valid || k0 >= K) return p;
  const int khw = g.KH * g.KW;
  int ci = k0 / khw;
  int rs = k0 - ci * khw;
  int kr = rs / g.KW;
  int ks = rs - kr * g.KW;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (k0 + j < K) {
      const int h = r.h0 + kr * g.DH, w = r.w0 + ks * g.DW;
      if (h >= 0 && h < g.H && w >= 0 && w < g.W)
        put(p, j, r.base[((long long)ci * g.H + h) * g.W + w]);
    }
    if (++ks == g.KW) {
      ks = 0;
      if (++kr == g.KH) { kr = 0; ++ci; }
    }
  }
  return p;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// IS_CONV: A is the im2col of `conv`; else A is `a` (M, K) row-major.
// out: NCHW int32 (conv, M = N*Ho*Wo) or (M, N) row-major.
template <bool IS_CONV>
__global__ void __launch_bounds__(THREADS)
s8_gemm_kernel(Conv conv, const int8_t* __restrict__ a,
               const int8_t* __restrict__ b, const int* __restrict__ bias,
               int* __restrict__ out, int M, int N, int K, bool a_vec,
               bool b_vec) {
  __shared__ __align__(16) int8_t As[2][BM][LDS];
  __shared__ __align__(16) int8_t Bs[2][BN][LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;         // mma group / thread
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int lrow = tid & (BM - 1), lk = (tid >> 6) * 16;   // loader slot

  ConvRow crow{};
  if constexpr (IS_CONV) crow = conv_row(conv, M, m0 + lrow);

  auto load_a = [&](int kt) {
    if constexpr (IS_CONV) return load_conv(conv, crow, K, kt * BK + lk);
    else return load_rows(a, M, K, m0 + lrow, kt * BK + lk, a_vec);
  };
  auto load_b = [&](int kt) {
    return load_rows(b, N, K, n0 + lrow, kt * BK + lk, b_vec);
  };
  auto store = [&](int buf, const Pack& pa, const Pack& pb) {
    *reinterpret_cast<uint4*>(&As[buf][lrow][lk]) =
        make_uint4(pa.w[0], pa.w[1], pa.w[2], pa.w[3]);
    *reinterpret_cast<uint4*>(&Bs[buf][lrow][lk]) =
        make_uint4(pb.w[0], pb.w[1], pb.w[2], pb.w[3]);
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  const int KT = (K + BK - 1) / BK;
  Pack pa = load_a(0), pb = load_b(0);
  store(0, pa, pb);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < KT;
    if (more) {                       // next step's loads in flight
      pa = load_a(kt + 1);
      pb = load_b(kt + 1);
    }
    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wm + i * 16 + g;
      af[i][0] = lds32(&As[buf][r][t * 4]);
      af[i][1] = lds32(&As[buf][r + 8][t * 4]);
      af[i][2] = lds32(&As[buf][r][16 + t * 4]);
      af[i][3] = lds32(&As[buf][r + 8][16 + t * 4]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = wn + j * 8 + g;
      bf[j][0] = lds32(&Bs[buf][c][t * 4]);
      bf[j][1] = lds32(&Bs[buf][c][16 + t * 4]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    if (more) store(buf ^ 1, pa, pb);
    __syncthreads();
  }

  // epilogue: c0, c1 at row g, columns 2t, 2t+1; c2, c3 at row g + 8
  const long long hw = (long long)conv.Ho * conv.Wo;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + g + half * 8;
      if (m >= M) continue;
      long long row_base, col_stride;
      if constexpr (IS_CONV) {
        const long long n_img = m / hw;
        row_base = n_img * N * hw + (m - n_img * hw);
        col_stride = hw;
      } else {
        row_base = (long long)m * N;
        col_stride = 1;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + j * 8 + t * 2 + e;
          if (col >= N) continue;
          int v = acc[i][j][half * 2 + e];
          if (bias != nullptr) v += bias[col];
          out[row_base + col * col_stride] = v;
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x int8 NCHW (N, C, H, W) and w int8 OIHW (Cout, C, KH, KW), contiguous;
// bias int32 (Cout,) or null; out int32 (N, Cout, Ho, Wo). Returns a
// cudaError_t code.
extern "C" int s8_conv(const void* x, const void* w, const void* bias,
                       void* out, int N, int C, int H, int W, int Cout,
                       int KH, int KW, int SH, int SW, int PH, int PW, int DH,
                       int DW, int Ho, int Wo, void* stream) {
  if (N < 1 || C < 1 || H < 1 || W < 1 || Cout < 1 || KH < 1 || KW < 1 ||
      SH < 1 || SW < 1 || PH < 0 || PW < 0 || DH < 1 || DW < 1 || Ho < 1 ||
      Wo < 1)
    return int(cudaErrorInvalidValue);
  const long long M = (long long)N * Ho * Wo;
  const long long K = (long long)C * KH * KW;
  if (M >= (1LL << 31) || K >= (1LL << 31) ||
      (Cout + BN - 1) / BN > 65535)
    return int(cudaErrorInvalidValue);
  Conv g{static_cast<const int8_t*>(x), C, H, W, KH, KW, SH, SW, PH, PW,
         DH, DW, Ho, Wo};
  const dim3 grid(unsigned((M + BM - 1) / BM), unsigned((Cout + BN - 1) / BN));
  s8_gemm_kernel<true><<<grid, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      g, nullptr, static_cast<const int8_t*>(w),
      static_cast<const int*>(bias), static_cast<int*>(out), int(M), Cout,
      int(K), false, K % 16 == 0 && aligned16(w));
  return int(cudaGetLastError());
}

// x int8 (M, K) and w int8 (N, K), row-major and contiguous; bias int32
// (N,) or null; out int32 (M, N). Returns a cudaError_t code.
extern "C" int s8_matmul(const void* x, const void* w, const void* bias,
                         void* out, int M, int N, int K, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (N + BN - 1) / BN > 65535)
    return int(cudaErrorInvalidValue);
  Conv none{};
  const dim3 grid(unsigned((M + BM - 1) / BM), unsigned((N + BN - 1) / BN));
  const bool vec = K % 16 == 0;
  s8_gemm_kernel<false><<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      none, static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int*>(bias), static_cast<int*>(out), M, N, K,
      vec && aligned16(x), vec && aligned16(w));
  return int(cudaGetLastError());
}

extern "C" const char* s8_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
