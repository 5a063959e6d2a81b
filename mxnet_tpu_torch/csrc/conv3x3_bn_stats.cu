// Fused 3x3 stride-1 SAME convolution + BatchNorm statistics for Hopper
// (sm_90a), kernel K3 of the port.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py:conv3x3_bn_stats
// (the pl.pallas_call there), which the trainable wrapper
// conv3x3_bn_relu_train calls. It computes the same function: for x
// (N, H, W, Cin) NHWC and w (3, 3, Cin, Cout) HWIO in one dtype,
//   acc[n, h, w, co] = sum_{kh, kw, ci} xpad[n, h + kh, w + kw, ci]
//                                       * w[kh, kw, ci, co]     (f32)
//   y     = acc stored in the input dtype
//   sum   = sum over n, h, w of acc      (f32, Cout)
//   sumsq = sum over n, h, w of acc^2    (f32, Cout)
// where xpad is x with one zero row / column on every side. The statistics
// are taken from the f32 accumulator, not from the rounded y, as the TPU
// kernel takes them from its VMEM accumulator.
//
// Design. Implicit GEMM: M = N*H*W output pixels, N = Cout, K = 9*Cin.
// One block of 256 threads owns a tile of BM = 64 pixels x BN = 64 output
// channels and loops over the 9 taps and, inside each, over Cin in chunks
// of BK = 32. For each (tap, chunk) it stages the shifted x tile and the
// w chunk in shared memory as f32 and accumulates 4 x 4 outputs per thread
// in f32 registers. The SAME halo is never materialised: a tap that falls
// outside the image is loaded as zero (the TPU kernel built the halo in
// VMEM for the same reason: a padded copy in HBM cost it its win). Ragged
// M and Cout tails and any Cin are masked.
//
// Statistics are deterministic. The TPU kernel summed over the grid's N
// axis in order. Here blocks run in no order, so no f32 atomics: each
// block writes its tile's per-channel sum and sum of squares (over its
// valid pixels, in a fixed order) to an f32 partials buffer
// (2, M tiles, Cout), and a second small kernel (bn_stats.cuh, shared with
// the other two K3 sources) reduces the partials of each channel in a fixed
// order. Two launches give bitwise-equal outputs.
//
// Thread layout: thread t owns rows tm + 16 i (tm = t / 16) and columns
// tn + 16 j (tn = t % 16), i, j < 4, so a warp reads the w chunk from 16
// consecutive shared-memory words (no bank conflict) and the x tile from
// two broadcast words. The x tile is stored transposed ([ci][pixel],
// stride 65) so that its stores, 32 channels of one pixel per warp, are
// conflict-free too.
//
// Bound on the H100 SXM. Each of ResNet-50's four 3x3 shapes at N = 32
// (56x56x64, 28x28x128, 14x14x256, 7x7x512, Cin = Cout) is
// 2*9*N*H*W*Cin*Cout = 7.40 GFLOP: 7.5 us at the 989 TFLOP/s bf16
// tensor-core peak. The bytes (x read once, y written once, w) are 25.8 MB
// at 56x56x64 (7.7 us at 3.35 TB/s), less for the others. So the deeper
// shapes are bound by operations and 56x56x64 by bytes, by a hair. This
// first design does its products on the f32 CUDA cores (67 TFLOP/s peak:
// no better than 0.11 ms per shape) from shared memory that feeds 8 loads
// per 16 FMAs, with no double buffering.
//
// Prediction, written before the first run on the card: 0.2-0.8 ms per
// shape at N = 32 in bf16 (9-37 TFLOP/s), 25-100x the bound, and 5-30x
// slower than cuDNN's conv alone; 7x7x512 the slowest for its few blocks
// (200 for 132 SMs) and its long K loop. Tensor cores (mma.sync, then
// wgmma + TMA) are the redesign's work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "bn_stats.cuh"

namespace {

constexpr int BM = 64;          // output pixels per block
constexpr int BN = 64;          // output channels per block
constexpr int BK = 32;          // input channels per staged chunk
constexpr int NT = 256;         // threads per block
constexpr int TM = 4;           // rows per thread
constexpr int TN = 4;           // columns per thread
constexpr int RSTEP = BM / TM;  // row stride between a thread's rows (16)
constexpr int CSTEP = BN / TN;  // column stride between its columns (16)
constexpr int AS = BM + 1;      // padded stride of the transposed x tile
constexpr int AR = BM * BK / NT;  // x elements each thread stages (8)
constexpr int BR = BK * BN / NT;  // w elements each thread stages (8)
static_assert(RSTEP * CSTEP == NT, "thread layout");
static_assert(NT % BK == 0 && NT % BN == 0, "staging layout");
static_assert(RSTEP * BN <= BK * AS && RSTEP * BN <= BK * BN,
              "the statistics reuse the staging buffers");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename scalar_t> __device__ scalar_t from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

template <typename scalar_t>
__global__ void __launch_bounds__(NT)
conv3x3_stats_kernel(const scalar_t* __restrict__ x,
                     const scalar_t* __restrict__ w,
                     scalar_t* __restrict__ y, float* __restrict__ part,
                     int height, int width, int cin, int cout, int m_total) {
  __shared__ float as[BK * AS];  // [ci][pixel] shifted x tile
  __shared__ float bs[BK * BN];  // [ci][co]    w chunk

  const int tid = threadIdx.x;
  const int tm = tid / CSTEP;
  const int tn = tid % CSTEP;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int hw = height * width;

  // x staging: this thread loads channel lane ka of tile pixels
  // tid / BK + (NT / BK) * r. Their (image, row, column) are fixed for the
  // whole K loop; a pixel past M gets a row no tap can bring into range.
  const int ka = tid % BK;
  int pimg[AR], prow[AR], pcol[AR];
#pragma unroll
  for (int r = 0; r < AR; ++r) {
    const int m = m0 + tid / BK + (NT / BK) * r;
    if (m < m_total) {
      pimg[r] = m / hw;
      const int rem = m - pimg[r] * hw;
      prow[r] = rem / width;
      pcol[r] = rem - prow[r] * width;
    } else {
      pimg[r] = 0;
      prow[r] = -4;
      pcol[r] = 0;
    }
  }
  // w staging: output-channel lane nb, chunk rows tid / BN + (NT / BN) * r
  const int nb = tid % BN;
  const int co_load = n0 + nb;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3 - 1;
    const int dw = tap % 3 - 1;
    for (int c0 = 0; c0 < cin; c0 += BK) {
      const int c = c0 + ka;
#pragma unroll
      for (int r = 0; r < AR; ++r) {
        const int hh = prow[r] + dh;
        const int ww = pcol[r] + dw;
        float v = 0.f;
        if (c < cin && hh >= 0 && hh < height && ww >= 0 && ww < width)
          v = to_f32(x[((size_t)pimg[r] * hw + (size_t)hh * width + ww) *
                           cin + c]);
        as[ka * AS + tid / BK + (NT / BK) * r] = v;
      }
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const int kk = tid / BN + (NT / BN) * r;
        const int ci = c0 + kk;
        float v = 0.f;
        if (ci < cin && co_load < cout)
          v = to_f32(w[((size_t)tap * cin + ci) * cout + co_load]);
        bs[kk * BN + nb] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = as[k * AS + tm + RSTEP * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = bs[k * BN + tn + CSTEP * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();  // the tile's readers are done before it is reloaded
    }
  }

  // Epilogue: store y in the input dtype; per-channel sums over this
  // thread's valid pixels, from the f32 accumulator.
  float cs[TN], cq[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) cs[j] = cq[j] = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm + RSTEP * i;
    if (m >= m_total) continue;
    scalar_t* yrow = y + (size_t)m * cout;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = n0 + tn + CSTEP * j;
      const float v = acc[i][j];
      if (co < cout) yrow[co] = from_f32<scalar_t>(v);
      cs[j] += v;
      cq[j] += v * v;
    }
  }
  // Reduce over the 16 row groups in a fixed order; the staging buffers
  // are free after the K loop's last barrier.
  float* red_s = as;  // [tm][BN]
  float* red_q = bs;  // [tm][BN]
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    red_s[tm * BN + tn + CSTEP * j] = cs[j];
    red_q[tm * BN + tn + CSTEP * j] = cq[j];
  }
  __syncthreads();
  if (tid < BN && n0 + tid < cout) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int g = 0; g < RSTEP; ++g) {
      s += red_s[g * BN + tid];
      q += red_q[g * BN + tid];
    }
    const size_t off = (size_t)blockIdx.x * cout + n0 + tid;
    part[off] = s;
    part[(size_t)gridDim.x * cout + off] = q;
  }
}

template <typename scalar_t>
cudaError_t launch(const void* x, const void* w, void* y, void* part,
                   void* sums, int n, int height, int width, int cin,
                   int cout, cudaStream_t stream) {
  const int m_total = n * height * width;
  const int m_tiles = (m_total + BM - 1) / BM;
  dim3 grid(m_tiles, (cout + BN - 1) / BN);
  conv3x3_stats_kernel<scalar_t><<<grid, NT, 0, stream>>>(
      static_cast<const scalar_t*>(x), static_cast<const scalar_t*>(w),
      static_cast<scalar_t*>(y), static_cast<float*>(part), height, width,
      cin, cout, m_total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_stats(part, sums, m_tiles, cout, stream);
}

}  // namespace

// Pixels per block: the partials buffer holds ceil(n*h*w / this) tiles.
extern "C" int conv3x3_bn_stats_block_m() { return BM; }

// dtype: 0 float32, 1 bfloat16, 2 float16. x (n, h, w, cin), w
// (3, 3, cin, cout), y (n, h, w, cout) contiguous in that dtype; part is
// f32 scratch of 2 * ceil(n*h*w / BM) * cout; sums is f32 (2, cout): sum
// then sum of squares. n*h*w*max(cin, cout) must fit in int32's range of
// pixels (the caller checks). Launches on `stream` and returns the
// launch's cudaError_t (0 on success); never synchronises.
extern "C" int conv3x3_bn_stats(const void* x, const void* w, void* y,
                                void* part, void* sums, int n, int height,
                                int width, int cin, int cout, int dtype,
                                void* stream) {
  if (n <= 0 || height <= 0 || width <= 0 || cin <= 0 || cout <= 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(launch<float>(x, w, y, part, sums, n, height, width, cin,
                               cout, s));
    case 1:
      return int(launch<__nv_bfloat16>(x, w, y, part, sums, n, height, width,
                                       cin, cout, s));
    case 2:
      return int(launch<__half>(x, w, y, part, sums, n, height, width, cin,
                                cout, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* conv3x3_bn_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
