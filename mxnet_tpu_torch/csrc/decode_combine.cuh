// The part of K4 (paged decode attention) that its two split kernels
// share: csrc/paged_decode_attn.cu (f32 and int8 pools, one element a
// lane) and csrc/paged_decode_attn_int8.cu (int8 pools, whole pages by
// bulk copy) include it. Each split kernel writes, for every (slot, split,
// head), the partial softmax state of its pages to an f32 workspace (B,
// splits, H, 2 + D): the running max m, the sum l and the unnormalised
// accumulator. The combine kernel folds a (slot, head)'s partials in split
// order, so a second launch is bitwise equal; a row with l = 0 everywhere
// (length 0) gives 0.
//
// ops/_build.py hashes this file into the digest of both sources.
// Everything here has internal linkage.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

namespace {

constexpr float NEG = -1e30f;      // the reference's mask value
constexpr int COMBINE_WARPS = 4;   // warps per CTA of the combine kernel
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ T from_f32(float x);
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

// One warp per (slot, head): the splits' partials in split order. The
// loads are spread over the lanes so that they overlap: lane j holds
// split j's max and sum (32 splits at a time, broadcast by shuffles), and
// each lane keeps the accumulators of its NV dims (d = lane + 32 k), whose
// loads over the splits are independent of one another.
template <typename QT, int NV>
__global__ void __launch_bounds__(COMBINE_WARPS * 32)
paged_decode_attn_combine_kernel(const float* __restrict__ work,
                                 QT* __restrict__ out, int B, int H, int D,
                                 int splits) {
  const int gw = blockIdx.x * COMBINE_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (gw >= B * H) return;
  const int b = gw / H, h = gw % H;
  const long long stride = (long long)H * (D + 2);   // one split's step
  const float* w0 = work + ((long long)b * splits * H + h) * (D + 2);
  float mx = NEG;
  for (int s = lane; s < splits; s += 32) mx = fmaxf(mx, w0[s * stride]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
  float total = 0.f, acc[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) acc[k] = 0.f;
  for (int c0 = 0; c0 < splits; c0 += 32) {
    const int sl = c0 + lane;
    const float e_l = sl < splits ? expf(w0[sl * stride] - mx) : 0.f;
    const float l_l = sl < splits ? w0[sl * stride + 1] : 0.f;
    const int n = min(32, splits - c0);
    for (int j = 0; j < n; ++j) {
      const float e = __shfl_sync(FULL, e_l, j);
      total += __shfl_sync(FULL, l_l, j) * e;
      const float* row = w0 + (c0 + j) * stride + 2;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int d = lane + 32 * k;
        if (d < D) acc[k] = fmaf(row[d], e, acc[k]);
      }
    }
  }
  QT* orow = out + ((long long)b * H + h) * D;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int d = lane + 32 * k;
    if (d < D) orow[d] = from_f32<QT>(total > 0.f ? acc[k] / total : 0.f);
  }
}

// MAX_D: the largest head dim the caller launches with (256 or 128).
template <typename QT, int MAX_D>
cudaError_t launch_combine(const void* work, void* out, int B, int H, int D,
                           int splits, cudaStream_t stream) {
  const int blocks = (B * H + COMBINE_WARPS - 1) / COMBINE_WARPS;
  const float* w = static_cast<const float*>(work);
  QT* o = static_cast<QT*>(out);
  if (D <= 32)
    paged_decode_attn_combine_kernel<QT, 1>
        <<<blocks, COMBINE_WARPS * 32, 0, stream>>>(w, o, B, H, D, splits);
  else if (D <= 64)
    paged_decode_attn_combine_kernel<QT, 2>
        <<<blocks, COMBINE_WARPS * 32, 0, stream>>>(w, o, B, H, D, splits);
  else if (MAX_D <= 128 || D <= 128)
    paged_decode_attn_combine_kernel<QT, 4>
        <<<blocks, COMBINE_WARPS * 32, 0, stream>>>(w, o, B, H, D, splits);
  else if constexpr (MAX_D > 128)
    paged_decode_attn_combine_kernel<QT, 8>
        <<<blocks, COMBINE_WARPS * 32, 0, stream>>>(w, o, B, H, D, splits);
  return cudaGetLastError();
}

}  // namespace
