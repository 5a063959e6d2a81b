// K5's requantize step for Hopper (sm_90a): int32 accumulators -> int8,
// under a calibrated output range or under the batch's own, both of
// mxnet_tpu's paths.
//
// Replaces mxnet_tpu/ops/quantization.py:_requant_epilogue (:207) and the
// batch-range branch of :_requantize (:141-144) that feeds it. The arithmetic is csrc/requant.cuh's (also the int8 conv's
// fused epilogue, csrc/s8_gemm_wgmma.cu): bitwise the plain versions
// (ops/quantization.py:requant_epilogue_reference, requant_range_reference)
// on finite values. The ranges are 0-d float32 tensors read here from
// device memory, never on the host, so a captured bucket replays with
// whatever they hold; a NaN in them (the NaN poison of a non-finite batch)
// propagates into the output range (-real_out, real_out), which block 0
// writes. Three modes:
//   0 calibrated:  real_out = max(|out_min|, |out_max|);
//   1 given range: real_out = *amax, the batch range a producer folded
//                  (the conv's epilogue mode "range");
//   2 own range:   a first kernel folds max |fl(fl(x) * a)| into *amax
//                  (zeroed first, one atomicMax a block), the second reads
//                  it. Three graph nodes: the memset and both kernels.
//
// Bound on the H100 SXM: bytes. It reads 4 and writes 1 byte an element,
// and mode 2 reads x once more. ResNet-18 v1's 28 standalone steps at N=128
// move ~2.1 GB (PERF.md §6).
//
// Design (a first version held ~8 KB in flight an SM -- 2 CTAs of 256
// threads, one 16-byte load each -- where 3.35 TB/s at HBM's latency
// needs ~20 KB): each thread issues UNROLL 16-byte loads before it
// computes or stores anything, one CTA a tile of THREADS x UNROLL x 4
// elements, as many CTAs as tiles, so 8 resident CTAs hold 128 KB in
// flight an SM. The tail past the last whole int4 and a misaligned x take
// a scalar loop. A 0 skips the division (requant.cuh): the zeros of a
// relu'd input sent whole warps down div.rn.f32's slow path.
#include "requant.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;                     // 16-byte loads a thread
constexpr int TILE4 = THREADS * UNROLL;       // int4s a CTA

struct Job {
  const int* x;
  int8_t* q;
  long long n;
  const float* real_in;
  const float* out_min;
  const float* out_max;
  unsigned* amax;
  float* lo;
  float* hi;
  int mode;
  bool vec;   // x 16-byte and q 4-byte aligned
};

// The tile's int4s, UNROLL a thread, all loaded before any is used.
__device__ __forceinline__ void load_tile(const Job& j, long long base,
                                          int4 (&v)[UNROLL],
                                          bool (&ok)[UNROLL]) {
  const long long n4 = j.n / 4;
  const int4* x4 = reinterpret_cast<const int4*>(j.x);
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long i = base + u * THREADS + threadIdx.x;
    ok[u] = i < n4;
    if (ok[u]) v[u] = __ldg(x4 + i);
  }
}

// Block 0's threads take the scalars past the last whole int4, or, for a
// misaligned x, every block takes a strided share of the elements.
template <typename F>
__device__ __forceinline__ void scalar_part(const Job& j, F f) {
  long long i, step;
  if (j.vec) {
    if (blockIdx.x != 0) return;
    i = j.n / 4 * 4 + threadIdx.x;
    step = THREADS;
  } else {
    i = (long long)blockIdx.x * THREADS + threadIdx.x;
    step = (long long)gridDim.x * THREADS;
  }
  for (; i < j.n; i += step) f(i);
}

template <int PATH>
__global__ void __launch_bounds__(THREADS)
requant_kernel(const Job j) {
  const float rin = *j.real_in;
  const float rout = j.mode == 0 ? rq::calibrated(j.out_min, j.out_max)
                                 : __uint_as_float(*j.amax);
  const rq::Scale sc = rq::make_scale<PATH>(rin, rout);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *j.lo = -rout;
    *j.hi = rout;
  }
  if (j.vec) {
    int4 v[UNROLL];
    bool ok[UNROLL];
    // mode 2 takes the tiles in reverse: the range pass read them in order,
    // so the last ones are the likeliest still in L2
    const long long tile =
        j.mode == 2 ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    const long long base = tile * TILE4;
    load_tile(j, base, v, ok);
    char4* q4 = reinterpret_cast<char4*>(j.q);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (ok[u])
        q4[base + u * THREADS + threadIdx.x] = make_char4(
            rq::requant<PATH>(v[u].x, sc), rq::requant<PATH>(v[u].y, sc),
            rq::requant<PATH>(v[u].z, sc), rq::requant<PATH>(v[u].w, sc));
  }
  scalar_part(j,
              [&](long long i) { j.q[i] = rq::requant<PATH>(j.x[i], sc); });
}

// Mode 2's first pass: max |fl(fl(x) * a)| of the block's elements, as
// float bits, into *amax.
__global__ void __launch_bounds__(THREADS)
requant_range_kernel(const Job j) {
  __shared__ uint32_t warp_max[THREADS / 32];
  const float a = rq::in_step(*j.real_in);
  uint32_t m = 0u;
  if (j.vec) {
    int4 v[UNROLL];
    bool ok[UNROLL];
    load_tile(j, (long long)blockIdx.x * TILE4, v, ok);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (ok[u])
        m = max(m, max(max(rq::abs_bits(v[u].x, a),
                           rq::abs_bits(v[u].y, a)),
                       max(rq::abs_bits(v[u].z, a),
                           rq::abs_bits(v[u].w, a))));
  }
  scalar_part(j, [&](long long i) { m = max(m, rq::abs_bits(j.x[i], a)); });
  m = __reduce_max_sync(0xffffffffu, m);
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < THREADS / 32 ? warp_max[threadIdx.x] : 0u;
    rq::fold_warp(m, j.amax);
  }
}

}  // namespace

// x int32 and q int8, contiguous, n elements; real_in float32 on the
// device; mode 0: out_min, out_max float32 on the device; mode 1: amax the
// range's float bits on the device; mode 2: amax a device word this call
// zeroes and fills; lo, hi float32 written with (-real_out, real_out);
// path 0 via_fp32, 1 fused_scale. Returns a cudaError_t code.
extern "C" int requant_int8(const void* x, void* q, long long n,
                            const void* real_in, const void* out_min,
                            const void* out_max, void* amax, void* lo,
                            void* hi, int mode, int path, void* stream) {
  if (n < 1 || path < 0 || path > 1 || mode < 0 || mode > 2 ||
      (mode == 0 && (out_min == nullptr || out_max == nullptr)) ||
      (mode != 0 && amax == nullptr))
    return int(cudaErrorInvalidValue);
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(q) & 3) == 0;
  long long blocks = vec ? (n / 4 + TILE4 - 1) / TILE4 : 0;
  if (!vec) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long want = (n + THREADS - 1) / THREADS;
    blocks = want < 8LL * sms ? want : 8LL * sms;
  }
  if (blocks < 1) blocks = 1;
  if (blocks >= (1LL << 31)) return int(cudaErrorInvalidValue);
  const Job j{static_cast<const int*>(x), static_cast<int8_t*>(q), n,
              static_cast<const float*>(real_in),
              static_cast<const float*>(out_min),
              static_cast<const float*>(out_max),
              static_cast<unsigned*>(amax), static_cast<float*>(lo),
              static_cast<float*>(hi), mode, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 2) {
    cudaError_t e = cudaMemsetAsync(amax, 0, sizeof(unsigned), s);
    if (e != cudaSuccess) return int(e);
    requant_range_kernel<<<unsigned(blocks), THREADS, 0, s>>>(j);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  if (path == 0)
    requant_kernel<0><<<unsigned(blocks), THREADS, 0, s>>>(j);
  else
    requant_kernel<1><<<unsigned(blocks), THREADS, 0, s>>>(j);
  return int(cudaGetLastError());
}

extern "C" const char* requant_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
