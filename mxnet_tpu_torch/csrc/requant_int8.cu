// K5's requantize step for Hopper (sm_90a): int32 accumulators -> int8
// under a calibrated output range, both of mxnet_tpu's paths.
//
// Replaces mxnet_tpu/ops/quantization.py:_requant_epilogue. With real_in
// the input grid's range, real_out = max(|out_min|, |out_max|) and
// d = max(real_out, 1e-20):
//   via_fp32:    q = rint(((float)x * (real_in / 2147483647)) * 127 / d)
//   fused_scale: q = rint((float)x * ((real_in / 2147483647) * (127 / d)))
// clipped to [-127, 127], rint rounding half to even as jnp.round and
// torch.round do. Every step is one IEEE float32 operation in exactly that
// order (__fmul_rn / __fdiv_rn: no FMA contraction, no reciprocal), so the
// result is bitwise that of the plain version
// (ops/quantization.py:requant_epilogue_reference) on finite values. The
// ranges are 0-d float32 tensors read here from device memory, never on
// the host, so a captured bucket replays with whatever they hold; a NaN in
// them (the NaN poison of a non-finite batch) propagates into the output
// range (-real_out, real_out), which block 0 writes, as jnp.maximum and
// torch.maximum propagate it.
//
// Bound on the H100 SXM: bytes. It reads 4 and writes 1 byte an element;
// ResNet-18 v1's 36 requantize steps at N=128 move ~1.5 GB (0.45 ms at
// 3.35 TB/s). Each thread takes four consecutive elements (one 16-byte
// load, one 4-byte store) in a grid-stride loop of 2 CTAs of 256 threads
// an SM. Fusing this step into s8_gemm.cu's epilogue would remove the
// int32 round trip altogether: that is the redesign (ROADMAP Queue 2).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

struct Scale {
  float a;        // real_in / 2147483647           (via_fp32)
  float d;        // max(real_out, 1e-20)            (via_fp32)
  float s;        // a * (127 / d)                   (fused_scale)
};

template <int PATH>
__device__ __forceinline__ int8_t requant(int x, const Scale& sc) {
  float v;
  if (PATH == 0)
    v = __fdiv_rn(__fmul_rn(__fmul_rn(__int2float_rn(x), sc.a), 127.f),
                  sc.d);
  else
    v = __fmul_rn(__int2float_rn(x), sc.s);
  v = fminf(fmaxf(rintf(v), -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(v));
}

template <int PATH>
__global__ void __launch_bounds__(THREADS)
requant_kernel(const int* __restrict__ x, int8_t* __restrict__ q,
               long long n, const float* real_in, const float* out_min,
               const float* out_max, float* lo, float* hi, bool vec) {
  const float rin = *real_in;
  const float rout = nan_max(fabsf(*out_min), fabsf(*out_max));
  Scale sc;
  sc.a = __fdiv_rn(rin, 2147483647.f);
  sc.d = (rout != rout) ? rout : fmaxf(rout, 1e-20f);
  sc.s = __fmul_rn(sc.a, __fdiv_rn(127.f, sc.d));
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *lo = -rout;
    *hi = rout;
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    const long long n4 = n / 4;
    const int4* x4 = reinterpret_cast<const int4*>(x);
    char4* q4 = reinterpret_cast<char4*>(q);
    for (; i < n4; i += stride) {
      const int4 v = x4[i];
      q4[i] = make_char4(requant<PATH>(v.x, sc), requant<PATH>(v.y, sc),
                         requant<PATH>(v.z, sc), requant<PATH>(v.w, sc));
    }
    i = n4 * 4 + (long long)blockIdx.x * blockDim.x + threadIdx.x;
  }
  for (; i < n; i += stride) q[i] = requant<PATH>(x[i], sc);
}

}  // namespace

// x int32 and q int8, contiguous, n elements; real_in, out_min, out_max
// float32 scalars on the device; lo, hi float32 scalars written with
// (-real_out, real_out); path 0 via_fp32, 1 fused_scale. Returns a
// cudaError_t code.
extern "C" int requant_int8(const void* x, void* q, long long n,
                            const void* real_in, const void* out_min,
                            const void* out_max, void* lo, void* hi, int path,
                            void* stream) {
  if (n < 1 || path < 0 || path > 1) return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n / 4 + THREADS - 1) / THREADS;
  const int blocks = int(want < 1 ? 1 : (want < 2LL * sms ? want : 2LL * sms));
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(q) & 3) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* xi = static_cast<const int*>(x);
  int8_t* qo = static_cast<int8_t*>(q);
  const float* ri = static_cast<const float*>(real_in);
  const float* mn = static_cast<const float*>(out_min);
  const float* mx = static_cast<const float*>(out_max);
  float* l = static_cast<float*>(lo);
  float* h = static_cast<float*>(hi);
  if (path == 0)
    requant_kernel<0><<<blocks, THREADS, 0, s>>>(xi, qo, n, ri, mn, mx, l, h,
                                                 vec);
  else
    requant_kernel<1><<<blocks, THREADS, 0, s>>>(xi, qo, n, ri, mn, mx, l, h,
                                                 vec);
  return int(cudaGetLastError());
}

extern "C" const char* requant_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
