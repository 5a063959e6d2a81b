// Flash-attention backward for Hopper (sm_90a), kernel K2, CUDA-core route.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py:_flash_bwd_blockwise, the
// backward that flash_attention_with_grad and flash_attention_with_lse
// pair with the Pallas forward (K1). There it is a lax.scan over K blocks;
// here it is three kernels that compute the same function. For q, k, v, O,
// dO of shape (B, H, T, D) in one dtype, the forward's f32 row
// log-sum-exp `lse` and, optionally, its cotangent `dlse`:
//   delta = rowsum(dO * O) - dlse                  (f32, one per row)
//   s     = (q * scale) k^T                        (as K1 forms it)
//   p     = exp(s - lse), exactly 0 where the key is masked
//   ds    = p * (dO v^T - delta)
//   dq    = scale * ds k,  dk = scale * ds^T q,  dv = p^T dO
// with every product and sum in f32 and the results stored in the input
// dtype. Key j is visible to query i when both lie inside T and, under
// causal masking, q_offset + i >= k_offset + j: the forward's own rule, so
// a masked score gives p = 0 in every row. A row that sees no key (only
// possible with offsets) has p = 0 throughout, so its dq is exactly 0 and
// it adds nothing to dk or dv: its forward output is the constant O = 0.
//
// This route takes every dtype and D <= 256 with any strides that have a
// unit D stride: fp32 callers and the head dimensions the tensor-core
// route (csrc/flash_attn_bwd_tc.cu: bf16/fp16, D 64 or 128,
// 16-byte-aligned rows) does not take; ops/kernels.py:_flash_bwd_route
// chooses.
//
// Design. A pre-pass writes delta (one warp per row). Then two kernels
// recompute P from lse instead of reading it, so the T x T matrices never
// reach device memory:
//   - dk/dv: one block per (batch * head, K tile of R rows). It keeps its K
//     and V tiles in shared memory and walks the Q tiles that can see the
//     tile (under causal masking, from the tile's first visible row on),
//     accumulating dk and dv for its rows in f32 registers.
//   - dq: one block per (batch * head, Q tile of R rows). It keeps its Q
//     and dO tiles and walks the K tiles its rows can see (up to the last
//     visible key, as K1 does), accumulating dq in f32 registers.
// Each output element is written by exactly one block and no float atomic
// is used, so a second launch is bitwise equal to the first. Both kernels
// skip the same tiles by the same visibility rule, and the partial tile on
// the diagonal is masked element by element in both.
//
// Operands are read where they lie: each of q, k, v, O, dO comes with its
// own (batch, head, row) element strides and unit stride in D. dq, dk, dv
// are written contiguous (B, H, T, D).
//
// Thread layout, as in csrc/flash_attn_fwd.cu: 128 threads, t in row group
// g = t / 8 (ROWS own rows of the block's tile) and column lane c = t % 8
// (columns c + 8m of the other tile, and D columns c + 8m of the
// accumulators). Tiles are staged in shared memory as f32, transposed
// ([d][row], stride R + 1) so every loop reads conflict-free. R is 64 rows
// for D <= 128 and 32 for D = 256, which keeps both the accumulators (at
// most 128 a thread) and the shared memory (at most 167 KB) in bounds. A
// head dimension below 64 or between the instantiations runs in the next
// larger one, its extra columns read as zero and never stored.
//
// Bound on the H100 SXM at the LM's shape (8, 12, 1024, 64) causal: the
// five T x T x D products over the causal half are 3.2e10 FLOP, 0.48 ms at
// the 67 TFLOP/s fp32 peak of the CUDA cores in fp32; every product here is
// an f32 FMA, and s and dO v^T are computed in both kernels (seven
// products instead of five) from tiles staged with plain loads.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;             // threads per block
constexpr int LANES = 8;            // column lanes per row group
constexpr int GROUPS = NT / LANES;  // row groups per block
enum { OP_Q, OP_K, OP_V, OP_O, OP_DO, N_OPS };

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

struct Args {
  const void* in[N_OPS];      // q, k, v, O, dO
  long long st[N_OPS][3];     // their (batch, head, row) element strides
  const float* lse;           // (B*H, T) f32
  const float* dlse;          // (B*H, T) f32, or null
  float* delta;               // (B*H, T) f32 scratch
  void* dq;                   // contiguous (B*H, T, D), input dtype
  void* dk;
  void* dv;
  int heads, t_len, d_real;
  float scale;
  int causal, q_offset, k_offset;
};

// element offset of row `row` of operand `op` in (batch * head) slice `bh`
__device__ __forceinline__ long long row_off(const Args& a, int op, int bh,
                                             int row) {
  const int b = bh / a.heads, h = bh % a.heads;
  return b * a.st[op][0] + h * a.st[op][1] + row * a.st[op][2];
}

template <int D>
struct Tile {
  static constexpr int R = D <= 128 ? 64 : 32;  // rows of a Q or K tile
  static constexpr int RS = R + 1;              // padded transposed stride
  static constexpr int ROWS = R / GROUPS;       // own rows per row group
  static constexpr int COLS = R / LANES;        // other-tile cols per lane
  static constexpr int DC = D / LANES;          // D columns per lane
};

// Stage rows [r0, r0 + R) of operand `op` transposed into dst[d][RS] as f32,
// times `mul`; rows past T and columns past d_real read as zero.
template <typename scalar_t, int D>
__device__ __forceinline__ void stage(const Args& a, int op, int bh, int r0,
                                      float mul, float* dst) {
  using TL = Tile<D>;
  const scalar_t* src = static_cast<const scalar_t*>(a.in[op]);
  for (int i = threadIdx.x; i < TL::R * D; i += NT) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (r0 + r < a.t_len && d < a.d_real)
      x = to_f32(src[row_off(a, op, bh, r0 + r) + d]) * mul;
    dst[d * TL::RS + r] = x;
  }
}

__device__ __forceinline__ bool visible(const Args& a, int i, int j) {
  return i < a.t_len && j < a.t_len &&
         (!a.causal ||
          (long long)a.q_offset + i >= (long long)a.k_offset + j);
}

// delta[r] = sum_d dO[r, d] * O[r, d] - dlse[r]: one warp per row.
template <typename scalar_t>
__global__ void __launch_bounds__(NT)
flash_bwd_delta_kernel(Args a, int rows) {
  const int r = blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int bh = r / a.t_len, i = r % a.t_len;
  const scalar_t* o = static_cast<const scalar_t*>(a.in[OP_O]) +
                      row_off(a, OP_O, bh, i);
  const scalar_t* g = static_cast<const scalar_t*>(a.in[OP_DO]) +
                      row_off(a, OP_DO, bh, i);
  float s = 0.f;
  for (int d = lane; d < a.d_real; d += 32)
    s = fmaf(to_f32(g[d]), to_f32(o[d]), s);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) a.delta[r] = s - (a.dlse ? a.dlse[r] : 0.f);
}

template <int D>
constexpr size_t dkdv_smem() {
  using TL = Tile<D>;
  // kt, vt, qt, dot [D][RS]; p and ds [R][RS]; lse, delta [R]
  return sizeof(float) * (4 * size_t(D) * TL::RS + 2 * size_t(TL::R) * TL::RS +
                          2 * TL::R);
}

template <typename scalar_t, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(Args a) {
  using TL = Tile<D>;
  constexpr int R = TL::R, RS = TL::RS, ROWS = TL::ROWS, COLS = TL::COLS,
                DC = TL::DC;
  extern __shared__ float smem[];
  float* kt = smem;               // [D][RS] K tile
  float* vt = kt + D * RS;        // [D][RS] V tile
  float* qt = vt + D * RS;        // [D][RS] Q tile, times scale
  float* dot = qt + D * RS;       // [D][RS] dO tile
  float* ps = dot + D * RS;       // [R][RS] p, as ps[i][j]
  float* dss = ps + R * RS;       // [R][RS] ds, as dss[i][j]
  float* lse_s = dss + R * RS;    // [R]
  float* delta_s = lse_s + R;     // [R]

  const int tid = threadIdx.x, g = tid / LANES, c = tid % LANES;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * R;  // tile 0, the one most Q tiles see, first
  stage<scalar_t, D>(a, OP_K, bh, k0, 1.f, kt);
  stage<scalar_t, D>(a, OP_V, bh, k0, 1.f, vt);

  float dk[ROWS][DC], dv[ROWS][DC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk[r][j] = dv[r][j] = 0.f;

  // Q tiles that can see a key of this tile: all, or under causal masking
  // those from the first row i with q_offset + i >= k_offset + k0 on.
  const int n_qb = (a.t_len + R - 1) / R;
  int qb = 0;
  if (a.causal) {
    const long long first =
        (long long)a.k_offset + k0 - (long long)a.q_offset;
    if (first >= a.t_len)
      qb = n_qb;
    else if (first > 0)
      qb = int(first / R);
  }
  for (; qb < n_qb; ++qb) {
    const int q0 = qb * R;
    __syncthreads();  // the previous tile's readers are done (K, V are in)
    stage<scalar_t, D>(a, OP_Q, bh, q0, a.scale, qt);
    stage<scalar_t, D>(a, OP_DO, bh, q0, 1.f, dot);
    for (int i = tid; i < R; i += NT) {
      const bool in = q0 + i < a.t_len;
      lse_s[i] = in ? a.lse[size_t(bh) * a.t_len + q0 + i] : 0.f;
      delta_s[i] = in ? a.delta[size_t(bh) * a.t_len + q0 + i] : 0.f;
    }
    __syncthreads();

    // s^T and (dO v^T)^T for own keys j = ROWS g + r, queries i = c + 8 m
    float s[ROWS][COLS], dp[ROWS][COLS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int m = 0; m < COLS; ++m) s[r][m] = dp[r][m] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float ka[ROWS], va[ROWS], qa[COLS], ga[COLS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        ka[r] = kt[d * RS + ROWS * g + r];
        va[r] = vt[d * RS + ROWS * g + r];
      }
#pragma unroll
      for (int m = 0; m < COLS; ++m) {
        qa[m] = qt[d * RS + c + LANES * m];
        ga[m] = dot[d * RS + c + LANES * m];
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int m = 0; m < COLS; ++m) {
          s[r][m] = fmaf(ka[r], qa[m], s[r][m]);
          dp[r][m] = fmaf(va[r], ga[m], dp[r][m]);
        }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int m = 0; m < COLS; ++m) {
        const int jl = ROWS * g + r, il = c + LANES * m;
        const float p = visible(a, q0 + il, k0 + jl)
                            ? expf(s[r][m] - lse_s[il]) : 0.f;
        ps[il * RS + jl] = p;
        dss[il * RS + jl] = p * (dp[r][m] - delta_s[il]);
      }
    __syncthreads();

    // dv += p^T dO, dk += ds^T (q * scale), over the tile's queries
#pragma unroll 2
    for (int i = 0; i < R; ++i) {
      float p[ROWS], ds[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        p[r] = ps[i * RS + ROWS * g + r];
        ds[r] = dss[i * RS + ROWS * g + r];
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float gv = dot[(c + LANES * j) * RS + i];
        const float qv = qt[(c + LANES * j) * RS + i];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          dv[r][j] = fmaf(p[r], gv, dv[r][j]);
          dk[r][j] = fmaf(ds[r], qv, dk[r][j]);
        }
      }
    }
  }

  scalar_t* dk_out = static_cast<scalar_t*>(a.dk);
  scalar_t* dv_out = static_cast<scalar_t*>(a.dv);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = k0 + ROWS * g + r;
    if (row >= a.t_len) continue;
    const size_t base = (size_t(bh) * a.t_len + row) * a.d_real;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int d = c + LANES * j;
      if (d < a.d_real) {
        dk_out[base + d] = from_f32<scalar_t>(dk[r][j]);
        dv_out[base + d] = from_f32<scalar_t>(dv[r][j]);
      }
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  using TL = Tile<D>;
  // qt, dot, kt, vt [D][RS]; ds [R][RS]; lse, delta [R]
  return sizeof(float) * (4 * size_t(D) * TL::RS + size_t(TL::R) * TL::RS +
                          2 * TL::R);
}

template <typename scalar_t, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(Args a) {
  using TL = Tile<D>;
  constexpr int R = TL::R, RS = TL::RS, ROWS = TL::ROWS, COLS = TL::COLS,
                DC = TL::DC;
  extern __shared__ float smem[];
  float* qt = smem;               // [D][RS] Q tile, times scale
  float* dot = qt + D * RS;       // [D][RS] dO tile
  float* kt = dot + D * RS;       // [D][RS] K tile
  float* vt = kt + D * RS;        // [D][RS] V tile
  float* dss = vt + D * RS;       // [R][RS] ds, as dss[j][i]
  float* lse_s = dss + R * RS;    // [R]
  float* delta_s = lse_s + R;     // [R]

  const int tid = threadIdx.x, g = tid / LANES, c = tid % LANES;
  const int bh = blockIdx.x;
  // the last Q tile, which sees the most K tiles, first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * R;
  stage<scalar_t, D>(a, OP_Q, bh, q0, a.scale, qt);
  stage<scalar_t, D>(a, OP_DO, bh, q0, 1.f, dot);
  for (int i = tid; i < R; i += NT) {
    const bool in = q0 + i < a.t_len;
    lse_s[i] = in ? a.lse[size_t(bh) * a.t_len + q0 + i] : 0.f;
    delta_s[i] = in ? a.delta[size_t(bh) * a.t_len + q0 + i] : 0.f;
  }

  float dq[ROWS][DC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < DC; ++j) dq[r][j] = 0.f;

  // K tiles to visit: all, or under causal masking those up to the last
  // key visible to the tile's last row (K1's rule).
  int n_kb = (a.t_len + R - 1) / R;
  if (a.causal) {
    const int last_q = q0 + min(R, a.t_len - q0) - 1;
    const long long last_key =
        (long long)a.q_offset + last_q - (long long)a.k_offset;
    if (last_key < 0)
      n_kb = 0;
    else if (last_key / R + 1 < n_kb)
      n_kb = int(last_key / R + 1);
  }
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * R;
    __syncthreads();  // the previous tile's readers are done (Q, dO are in)
    stage<scalar_t, D>(a, OP_K, bh, k0, 1.f, kt);
    stage<scalar_t, D>(a, OP_V, bh, k0, 1.f, vt);
    __syncthreads();

    // s and dO v^T for own queries i = ROWS g + r, keys j = c + 8 m
    float s[ROWS][COLS], dp[ROWS][COLS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int m = 0; m < COLS; ++m) s[r][m] = dp[r][m] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[ROWS], ga[ROWS], ka[COLS], va[COLS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        qa[r] = qt[d * RS + ROWS * g + r];
        ga[r] = dot[d * RS + ROWS * g + r];
      }
#pragma unroll
      for (int m = 0; m < COLS; ++m) {
        ka[m] = kt[d * RS + c + LANES * m];
        va[m] = vt[d * RS + c + LANES * m];
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int m = 0; m < COLS; ++m) {
          s[r][m] = fmaf(qa[r], ka[m], s[r][m]);
          dp[r][m] = fmaf(ga[r], va[m], dp[r][m]);
        }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int m = 0; m < COLS; ++m) {
        const int il = ROWS * g + r, jl = c + LANES * m;
        const float p = visible(a, q0 + il, k0 + jl)
                            ? expf(s[r][m] - lse_s[il]) : 0.f;
        dss[jl * RS + il] = p * (dp[r][m] - delta_s[il]);
      }
    __syncthreads();

    // dq += ds k over the tile's keys (times scale at the store)
#pragma unroll 2
    for (int j = 0; j < R; ++j) {
      float ds[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) ds[r] = dss[j * RS + ROWS * g + r];
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float kv = kt[(c + LANES * dc) * RS + j];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) dq[r][dc] = fmaf(ds[r], kv, dq[r][dc]);
      }
    }
  }

  scalar_t* dq_out = static_cast<scalar_t*>(a.dq);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = q0 + ROWS * g + r;
    if (row >= a.t_len) continue;
    const size_t base = (size_t(bh) * a.t_len + row) * a.d_real;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      const int d = c + LANES * dc;
      if (d < a.d_real)
        dq_out[base + d] = from_f32<scalar_t>(dq[r][dc] * a.scale);
    }
  }
}

template <typename scalar_t, int D>
cudaError_t launch(const Args& a, int bh, cudaStream_t stream) {
  auto dkdv = flash_bwd_dkdv_kernel<scalar_t, D>;
  auto dq = flash_bwd_dq_kernel<scalar_t, D>;
  constexpr size_t smem_kv = dkdv_smem<D>(), smem_q = dq_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_kv));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem_q));
  if (err != cudaSuccess) return err;
  const int rows = bh * a.t_len;
  flash_bwd_delta_kernel<scalar_t>
      <<<(rows + NT / 32 - 1) / (NT / 32), NT, 0, stream>>>(a, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (a.t_len + Tile<D>::R - 1) / Tile<D>::R);
  dkdv<<<grid, NT, smem_kv, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq<<<grid, NT, smem_q, stream>>>(a);
  return cudaGetLastError();
}

template <typename scalar_t>
cudaError_t dispatch_d(const Args& a, int bh, cudaStream_t stream) {
  if (a.d_real <= 64) return launch<scalar_t, 64>(a, bh, stream);
  if (a.d_real <= 128) return launch<scalar_t, 128>(a, bh, stream);
  return launch<scalar_t, 256>(a, bh, stream);
}

// Fill Args from the C interface's arguments.
Args make_args(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, const void* dlse,
               void* delta, void* dq, void* dk, void* dv,
               const long long* strides, int heads, int t_len, int d,
               float scale, int causal, int q_offset, int k_offset) {
  Args a;
  const void* in[N_OPS] = {q, k, v, o, dout};
  for (int op = 0; op < N_OPS; ++op) {
    a.in[op] = in[op];
    for (int i = 0; i < 3; ++i) a.st[op][i] = strides[3 * op + i];
  }
  a.lse = static_cast<const float*>(lse);
  a.dlse = static_cast<const float*>(dlse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.heads = heads;
  a.t_len = t_len;
  a.d_real = d;
  a.scale = scale;
  a.causal = causal;
  a.q_offset = q_offset;
  a.k_offset = k_offset;
  return a;
}

bool bad_size(int batch, int heads, int t_len, int d) {
  return batch <= 0 || heads <= 0 || t_len <= 0 || d <= 0 || d > 256 ||
         (long long)batch * heads * t_len > 0x7fffffffLL ||
         t_len > 65535 * 32;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. q, k, v, o, dout are
// (batch, heads, t, d) with unit stride in d and the (batch, head, row)
// element strides in `strides` (15 values, in that operand order); lse and
// dlse (may be null) are contiguous f32 (batch * heads, t); delta is f32
// scratch of the same size; dq, dk, dv are contiguous (batch, heads, t, d).
// Launches on `stream` and returns the first failing launch's cudaError_t
// (0 on success); never synchronises.
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, const void* dlse, void* delta,
                              void* dq, void* dk, void* dv,
                              const long long* strides, int batch, int heads,
                              int t_len, int d, int dtype, float scale,
                              int causal, int q_offset, int k_offset,
                              void* stream) {
  if (bad_size(batch, heads, t_len, d)) return int(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, o, dout, lse, dlse, delta, dq, dk, dv,
                           strides, heads, t_len, d, scale, causal, q_offset,
                           k_offset);
  const int bh = batch * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(dispatch_d<float>(a, bh, s));
    case 1:
      return int(dispatch_d<__nv_bfloat16>(a, bh, s));
    case 2:
      return int(dispatch_d<__half>(a, bh, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
