// The int8 KV write of the decode path for Hopper (sm_90a): K4's write
// side, one launch for K and V of one layer.
//
// Replaces mxnet_tpu/ops/decode_attention.py:kv_quantize (symmetric int8
// quantization with one f32 scale per (token, head)) and the page scatter
// that follows it (mxnet_tpu/gluon/model_zoo/transformer.py:_page_scatter,
// `.at[page_idx, slot_idx].set`). For each row r of k and v (N, H, D) in
// f32, bf16 or f16, read through their strides, and each head h:
//   amax  = max_d |x_d|
//   scale = amax / 127, divided and rounded in x's dtype, then f32; 1 if
//           amax is 0
//   x_q   = clip(rint(x_d / scale), -127, 127)   (IEEE division, ties to
//           even)
// and x_q goes to pages[page_idx[r], slot_idx[r], h, :] (int8 (P,
// page_size, H, D)), scale to scales[page_idx[r], slot_idx[r], h] (f32 (P,
// page_size, H)). The values and scales are bitwise those of the plain
// version (ops/decode_attention.py:kv_quantize_write_reference). A row
// whose page or slot lies outside the pool is dropped; where two rows name
// the same (page, slot), either may win, as with index_put_.
//
// Bound on the H100 SXM: bytes, and far below the launch's own cost. At
// the decode step's shape (N=32 rows, H=12, D=64, bf16) it reads 98 KB and
// writes 49 KB of int8 and 3 KB of scales: 0.05 us at 3.35 TB/s. What it
// saves is the plain chain's ~24 launches a layer (the quantize's
// elementwise and reduction kernels and two index_put_ for each of K and
// V), so the design is one simple launch: a warp per (K or V, row, head),
// each lane holding the dims lane + 32 j in registers, the amax reduced by
// xor shuffles.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;              // warps per CTA
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// amax / 127 as the plain version computes it in T: the f32 quotient
// rounded to T (a 16-bit division is an f32 division rounded once).
__device__ __forceinline__ float scale_of(float amax, float) {
  return __fdiv_rn(amax, 127.f);
}
__device__ __forceinline__ float scale_of(float amax, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(__fdiv_rn(amax, 127.f)));
}
__device__ __forceinline__ float scale_of(float amax, __half) {
  return __half2float(__float2half_rn(__fdiv_rn(amax, 127.f)));
}

struct Side {                         // K or V: the rows and where they go
  const void* x;
  long long s0, s1, s2;               // x's element strides (row, head, dim)
  int8_t* pages;
  float* scales;
};

template <typename T, int NV>
__global__ void __launch_bounds__(WARPS * 32)
kv_quantize_write_kernel(Side k, Side v, const long long* __restrict__ page,
                         const long long* __restrict__ slot, int N, int H,
                         int D, int P, int ps) {
  const long long unit =
      (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const long long rows = (long long)N * H;
  if (unit >= 2 * rows) return;
  // the fields one by one: a reference to either parameter would put
  // both in local memory
  const bool is_v = unit >= rows;
  const long long u = is_v ? unit - rows : unit;
  const int r = int(u / H), h = int(u % H);
  const long long pg = page[r], sl = slot[r];
  if (pg < 0 || pg >= P || sl < 0 || sl >= ps) return;
  const T* src = static_cast<const T*>(is_v ? v.x : k.x) +
                 r * (is_v ? v.s0 : k.s0) + h * (is_v ? v.s1 : k.s1);
  const long long s2 = is_v ? v.s2 : k.s2;
  float x[NV];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int d = lane + 32 * j;
    x[j] = d < D ? to_f32(src[d * s2]) : 0.f;
    amax = fmaxf(amax, fabsf(x[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, o));
  const float scale = amax > 0.f ? scale_of(amax, T()) : 1.f;
  const long long at = (pg * ps + sl) * H + h;
  int8_t* dst = (is_v ? v.pages : k.pages) + at * D;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int d = lane + 32 * j;
    if (d < D) {
      const float qv = rintf(__fdiv_rn(x[j], scale));
      dst[d] = int8_t(fminf(fmaxf(qv, -127.f), 127.f));
    }
  }
  if (lane == 0) (is_v ? v.scales : k.scales)[at] = scale;
}

template <typename T, int NV>
cudaError_t launch(const Side& k, const Side& v, const long long* page,
                   const long long* slot, int N, int H, int D, int P, int ps,
                   cudaStream_t stream) {
  const long long units = 2LL * N * H;
  const long long blocks = (units + WARPS - 1) / WARPS;
  kv_quantize_write_kernel<T, NV><<<unsigned(blocks), WARPS * 32, 0,
                                    stream>>>(k, v, page, slot, N, H, D, P,
                                              ps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Side& k, const Side& v, const long long* page,
                       const long long* slot, int N, int H, int D, int P,
                       int ps, cudaStream_t s) {
  if (D <= 32) return launch<T, 1>(k, v, page, slot, N, H, D, P, ps, s);
  if (D <= 64) return launch<T, 2>(k, v, page, slot, N, H, D, P, ps, s);
  if (D <= 128) return launch<T, 4>(k, v, page, slot, N, H, D, P, ps, s);
  return launch<T, 8>(k, v, page, slot, N, H, D, P, ps, s);
}

}  // namespace

// dtype: k's and v's code (0 f32, 1 bf16, 2 f16); k, v (N, H, D) by
// element strides; page, slot int64 (N,); k_pages, v_pages int8 and
// k_scales, v_scales f32, contiguous (P, ps, H, D) and (P, ps, H). D <= 256.
// Returns a cudaError_t code.
extern "C" int kv_quantize_write(
    const void* k, long long ks0, long long ks1, long long ks2, const void* v,
    long long vs0, long long vs1, long long vs2, const void* page,
    const void* slot, void* k_pages, void* v_pages, void* k_scales,
    void* v_scales, int N, int H, int D, int P, int ps, int dtype,
    void* stream) {
  if (N < 1 || H < 1 || D < 1 || D > 256 || P < 1 || ps < 1 || dtype < 0 ||
      dtype > 2 || 2LL * N * H > 65535LL * 65535LL)
    return int(cudaErrorInvalidValue);
  const Side kside{k, ks0, ks1, ks2, static_cast<int8_t*>(k_pages),
                   static_cast<float*>(k_scales)};
  const Side vside{v, vs0, vs1, vs2, static_cast<int8_t*>(v_pages),
                   static_cast<float*>(v_scales)};
  const long long* pg = static_cast<const long long*>(page);
  const long long* sl = static_cast<const long long*>(slot);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(dispatch_d<float>(kside, vside, pg, sl, N, H, D, P, ps, s));
    case 1:
      return int(
          dispatch_d<__nv_bfloat16>(kside, vside, pg, sl, N, H, D, P, ps, s));
    default:
      return int(dispatch_d<__half>(kside, vside, pg, sl, N, H, D, P, ps, s));
  }
}

extern "C" const char* kv_quantize_write_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
