// Flash-attention forward for Hopper (sm_90a), kernel K1 of the port.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py:_mha_kernel, as
// built by _build_flash (the pl.pallas_call there) and reached through
// flash_attention. It computes the same function: for q, k, v of shape
// (BH, T, D) in one dtype,
//   s   = (q * scale) k^T              (q scaled in f32 before the product)
//   s   = -inf where causal and q_offset + i < k_offset + j, or j >= T
//   O   = softmax(s) v                 (stored in the input dtype)
//   lse = m + log(max(l, 1e-20))       (f32, m = row max, l = row sum)
// with an online softmax, so the T x T score matrix never reaches device
// memory. A row with no visible key (only possible with offsets) gives
// O = 0 and lse = -1e30 + log(1e-20): the running max starts at -1e30 and
// masked scores contribute exactly zero to l and to the accumulator.
//
// Design. One block of 128 threads owns a tile of BQ = 64 query rows of
// one (batch, head); the grid is (ceil(T / BQ), B * H). The TPU kernel's
// innermost sequential grid axis over K tiles, which carried (m, l, acc)
// in VMEM scratch from step to step, becomes a loop inside the block that
// carries them in registers. Each K/V tile (BK = 64 rows) is staged in
// shared memory as f32; scores, the online softmax and the output
// accumulator stay in f32 registers, and the probabilities pass through
// shared memory to the P.V product. K tiles wholly in the causal future of
// the Q tile are never loaded. T need not be a multiple of the tile: the
// ragged tail is masked here. D is a template parameter (64, 128, 256);
// a smaller head dimension runs in the next larger instantiation with the
// extra columns read as zero and never stored.
//
// Thread layout: thread t belongs to row group g = t / 8 (query rows
// 4g .. 4g+3 of the tile) and column lane c = t % 8 (key columns c + 8j
// for the scores, output columns c + 8j for the accumulator). The eight
// lanes of a row group are adjacent in one warp, so row max and row sum
// reduce with three xor shuffles. Q and K are stored transposed ([d][row],
// stride 65) so the score loop reads conflict-free.
//
// Bound on the H100 SXM. At B=8, H=12, T=1024, D=64, causal, bf16 the
// work is about 1.3e10 FLOP (QK^T and PV over the causal half), about
// 13 us at the 989 TFLOP/s bf16 tensor-core peak, and the bytes moved
// (q, k, v read once, O written once, lse) are about 50 MB, about 15 us
// at 3.35 TB/s. This first design does its products on the f32 CUDA
// cores from shared memory, not on the tensor cores, so it is far from
// that bound; wgmma, TMA and warp specialisation are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // key rows per tile
constexpr int NT = 128;         // threads per block
constexpr int LANES = 8;        // column lanes per row group
constexpr int ROWS = 4;         // query rows per row group
constexpr int QS = BQ + 1;      // padded stride of the transposed Q/P tiles
constexpr int KS = BK + 1;      // padded stride of the transposed K tile
constexpr float NEG = -1e30f;   // the TPU kernel's mask value
static_assert(NT == (BQ / ROWS) * LANES, "thread layout");
static_assert(BK == 8 * LANES, "each lane owns 8 key columns");

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

template <int D>
constexpr size_t smem_bytes() {
  // qt [D][QS] + kt [D][KS] + vs [BK][D] + pt [BK][QS], all f32
  return sizeof(float) * (size_t(D) * QS + size_t(D) * KS + size_t(BK) * D +
                          size_t(BK) * QS);
}

template <typename scalar_t, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const scalar_t* __restrict__ q,
                 const scalar_t* __restrict__ k,
                 const scalar_t* __restrict__ v, scalar_t* __restrict__ o,
                 float* __restrict__ lse, int t_len, int d_real, float scale,
                 int causal, int q_offset, int k_offset) {
  extern __shared__ float smem[];
  float* qt = smem;              // [D][QS]  scaled Q, transposed
  float* kt = qt + D * QS;       // [D][KS]  K tile, transposed
  float* vs = kt + D * KS;       // [BK][D]  V tile
  float* pt = vs + BK * D;       // [BK][QS] probabilities, transposed

  constexpr int DC = D / LANES;  // output columns per lane
  const int tid = threadIdx.x;
  const int g = tid / LANES;
  const int c = tid % LANES;
  const int q0 = blockIdx.x * BQ;
  const size_t base = size_t(blockIdx.y) * t_len * d_real;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (q0 + r < t_len && d < d_real)
      x = to_f32(q[base + size_t(q0 + r) * d_real + d]) * scale;
    qt[d * QS + r] = x;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  // K tiles to visit: all of them, or under causal masking only those
  // holding a key visible to some row of this Q tile.
  int n_kb = (t_len + BK - 1) / BK;
  if (causal) {
    const int last_q = q0 + min(BQ, t_len - q0) - 1;
    const long long last_key =
        (long long)q_offset + last_q - (long long)k_offset;
    if (last_key < 0)
      n_kb = 0;
    else if (last_key / BK + 1 < n_kb)
      n_kb = int(last_key / BK + 1);
  }

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tile's readers are done (and Q is in)
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < t_len && d < d_real) {
        const size_t off = base + size_t(k0 + r) * d_real + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      kt[d * KS + r] = kx;
      vs[r * D + d] = vx;
    }
    __syncthreads();

    float s[ROWS][8];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[ROWS], ka[8];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qa[i] = qt[d * QS + ROWS * g + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) ka[j] = kt[d * KS + c + LANES * j];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const long long qpos = (long long)q_offset + q0 + ROWS * g + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + c + LANES * j;
        const bool ok = col < t_len &&
                        (!causal || qpos >= (long long)k_offset + col);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < LANES; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);  // finite: m starts at -1e30
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);  // masked: exp(-inf) = 0
        rs += p;
        pt[(c + LANES * j) * QS + ROWS * g + i] = p;
      }
#pragma unroll
      for (int w = 1; w < LANES; w <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) p[i] = pt[j * QS + ROWS * g + i];
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float vv = vs[j * D + c + LANES * dc];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i][dc] = fmaf(p[i], vv, acc[i][dc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + ROWS * g + i;
    if (row >= t_len) continue;
    const float lc = fmaxf(l[i], 1e-20f);
    scalar_t* orow = o + base + size_t(row) * d_real;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      const int d = c + LANES * dc;
      if (d < d_real) orow[d] = from_f32<scalar_t>(acc[i][dc] / lc);
    }
    if (c == 0) lse[size_t(blockIdx.y) * t_len + row] = m[i] + logf(lc);
  }
}

template <typename scalar_t, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int t_len, int d_real, float scale,
                   int causal, int q_offset, int k_offset,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<scalar_t, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((t_len + BQ - 1) / BQ, bh);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
      static_cast<const scalar_t*>(v), static_cast<scalar_t*>(o),
      static_cast<float*>(lse), t_len, d_real, scale, causal, q_offset,
      k_offset);
  return cudaGetLastError();
}

template <typename scalar_t>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int t_len, int d, float scale,
                       int causal, int q_offset, int k_offset,
                       cudaStream_t stream) {
  if (d <= 64)
    return launch<scalar_t, 64>(q, k, v, o, lse, bh, t_len, d, scale, causal,
                                q_offset, k_offset, stream);
  if (d <= 128)
    return launch<scalar_t, 128>(q, k, v, o, lse, bh, t_len, d, scale,
                                 causal, q_offset, k_offset, stream);
  return launch<scalar_t, 256>(q, k, v, o, lse, bh, t_len, d, scale, causal,
                               q_offset, k_offset, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. q, k, v, o are contiguous
// (bh, t, d); lse is contiguous f32 (bh, t). Launches on `stream` and
// returns the launch's cudaError_t (0 on success); never synchronises.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int t_len, int d,
                              int dtype, float scale, int causal,
                              int q_offset, int k_offset, void* stream) {
  if (bh <= 0 || t_len <= 0 || d <= 0 || d > 256)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(dispatch_d<float>(q, k, v, o, lse, bh, t_len, d, scale,
                                   causal, q_offset, k_offset, s));
    case 1:
      return int(dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, t_len, d,
                                           scale, causal, q_offset, k_offset,
                                           s));
    case 2:
      return int(dispatch_d<__half>(q, k, v, o, lse, bh, t_len, d, scale,
                                    causal, q_offset, k_offset, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
