// K5's requantize arithmetic (sm_90a), shared by csrc/requant_int8.cu (the
// standalone step) and csrc/s8_gemm_wgmma.cu (the int8 conv's fused
// epilogue), so both are bitwise the plain versions in
// ops/quantization.py (requant_epilogue_reference, requant_range_reference).
//
// With real_in the input grid's range, real_out = max(|out_min|, |out_max|)
// and d = max(real_out, 1e-20):
//   via_fp32:    q = rint(((float)x * (real_in / 2147483647)) * 127 / d)
//   fused_scale: q = rint((float)x * ((real_in / 2147483647) * (127 / d)))
// clipped to [-127, 127], rint rounding half to even as jnp.round and
// torch.round do. Every step is one IEEE float32 operation in exactly that
// order (__fmul_rn / __fdiv_rn: no FMA contraction, no reciprocal). NaN in
// a range propagates as jnp.maximum and torch.maximum propagate it.
//
// The batch range of a requantize without a calibrated one
// (mxnet_tpu/ops/quantization.py:141-144) is max |fl(fl(x) * a)|, a =
// real_in / 2147483647, NaN propagating. Its fold: the bits of fabsf(v)
// (sign cleared) order as unsigned integers the way the floats order, and
// every NaN orders above +inf, so an unsigned max of the bits, in any order
// (warp reduce, atomicMax), is exactly that max, its NaN included.
//
// An input of 0 skips the division: IEEE division on sm_90 (div.rn.f32) is
// a reciprocal, Newton steps and an FCHK test whose slow path a zero
// dividend takes (PERF.md §6; tools/torch_requant_variants.py), and a warp
// waits for its slowest lane.
// The skip gives what the division gives (+-0, rint 0, stored 0) wherever
// the scale is finite; where it is not (NaN poison, an infinite real_in),
// the division runs as before.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rq {

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

// real_in / 2147483647: one step of the int32 grid
__device__ __forceinline__ float in_step(float real_in) {
  return __fdiv_rn(real_in, 2147483647.f);
}

struct Scale {
  float a;      // real_in / 2147483647           (via_fp32)
  float d;      // max(real_out, 1e-20), NaN kept  (via_fp32)
  float s;      // a * (127 / d)                   (fused_scale)
  bool skip0;   // a 0 input gives 0 without its float steps
};

template <int PATH>
__device__ __forceinline__ Scale make_scale(float real_in, float real_out) {
  Scale sc;
  sc.a = in_step(real_in);
  sc.d = (real_out != real_out) ? real_out : fmaxf(real_out, 1e-20f);
  sc.s = __fmul_rn(sc.a, __fdiv_rn(127.f, sc.d));
  sc.skip0 = PATH == 0 ? (isfinite(sc.a) && isfinite(sc.d)) : isfinite(sc.s);
  return sc;
}

// real_out of a calibrated range (out_min, out_max)
__device__ __forceinline__ float calibrated(const float* out_min,
                                            const float* out_max) {
  return nan_max(fabsf(*out_min), fabsf(*out_max));
}

template <int PATH>
__device__ __forceinline__ int8_t requant(int x, const Scale& sc) {
  const bool zero = x == 0 && sc.skip0;
  float v;
  if (PATH == 0) {
    const float num = __fmul_rn(__fmul_rn(__int2float_rn(x), sc.a), 127.f);
    v = __fdiv_rn(zero ? 1.f : num, sc.d);
  } else {
    v = __fmul_rn(__int2float_rn(x), sc.s);
  }
  v = fminf(fmaxf(rintf(v), -127.f), 127.f);
  return zero ? int8_t(0) : static_cast<int8_t>(__float2int_rn(v));
}

// the bits of |fl(fl(x) * a)|, ordered as the batch range's max
__device__ __forceinline__ uint32_t abs_bits(int x, float a) {
  return __float_as_uint(fabsf(__fmul_rn(__int2float_rn(x), a)));
}

// The warp's max of m, folded into *word by lane 0 (every lane calls).
__device__ __forceinline__ void fold_warp(uint32_t m, unsigned* word) {
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0 && m != 0u) atomicMax(word, m);
}

}  // namespace rq
