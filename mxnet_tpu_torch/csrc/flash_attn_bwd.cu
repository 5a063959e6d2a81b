// Flash-attention backward for Hopper (sm_90a), kernel K2 of the port.
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
// own (batch, head, row) element strides and unit stride in D, so the LM's
// q/k/v views of the qkv projection and the tensor-core K1's O, a
// (B, H, T, D) view of (B, T, H, D) memory, are read without copies.
// dq, dk, dv are written contiguous (B, H, T, D).
//
// Two routes share the pre-pass, the Args and the tile walk, chosen by
// ops/kernels.py:_flash_bwd_route: the tensor-core route (flash_attn_bwd_tc:
// bf16/fp16, D 64 or 128, 16-byte-aligned rows; described at its kernels
// below) and the CUDA-core route (flash_attn_bwd: every dtype, D <= 256,
// any strides with a unit D stride), whose layout follows.
//
// CUDA-core thread layout, as in csrc/flash_attn_fwd.cu: 128 threads, t in
// row group g = t / 8 (ROWS own rows of the block's tile) and column lane
// c = t % 8 (columns c + 8m of the other tile, and D columns c + 8m of the
// accumulators). Tiles are staged in shared memory as f32, transposed
// ([d][row], stride R + 1) so every loop reads conflict-free. R is 64 rows
// for D <= 128 and 32 for D = 256, which keeps both the accumulators (at
// most 128 a thread) and the shared memory (at most 167 KB) in bounds. A
// head dimension below 64 or between the instantiations runs in the next
// larger one, its extra columns read as zero and never stored.
//
// Bound on the H100 SXM at the LM's shape, B=8, H=12, T=1024, D=64,
// causal, bf16: the five T x T x D products over the causal half are
// 3.2e10 FLOP, 0.033 ms at the 989 TFLOP/s bf16 tensor-core peak; q, k,
// v, O, dO read once and dq, dk, dv written once are about 101 MB, 0.030
// ms at 3.35 TB/s: bound by operations. Both routes recompute s and dO v^T
// in both kernels (seven products instead of five) and stage tiles with
// plain loads and no overlap; the tensor-core route runs its products as
// mma.sync, p and ds as hi + lo terms (two products each), so it is far
// from that bound too. wgmma products, TMA loads in a pipelined ring and
// one (B, T, 3H, D) gradient for the qkv projection are later work.
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

// ------------------------------------------------------------ tensor cores
// The 16-bit route: the same three passes, with every product on the
// tensor cores by warp-level mma.sync (m16n8k16, f32 accumulators) from
// ldmatrix fragments. Each of the 4 warps owns 16 rows of the block's
// tile; s and dO v^T stay in the accumulator registers, p and ds are
// turned into the A operand of the next product in registers, each as
// hi + lo 16-bit terms (p rounded once to 16 bits would leave dv ~10
// output ulps off), and the 16-bit tiles sit in shared memory with rows
// padded by 16 bytes so ldmatrix reads them without bank conflicts.
// Operands need a unit D stride, (batch, head, row) strides in multiples
// of 8 elements and 16-byte-aligned bases (16-byte row loads).

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

template <typename scalar_t> struct Tc;

template <> struct Tc<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // (x, y) -> hi + lo, each two packed bf16 (x in the low half)
  static __device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                               uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
};

template <> struct Tc<__half> {
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                               uint32_t& lo) {
    const __half2 h = __floats2half2_rn(x, y);
    const float2 hf = __half22float2(h);
    const __half2 l = __floats2half2_rn(x - hf.x, y - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
};

template <int D>
struct TcTile {
  static constexpr int LD = D + 8;           // padded row, in elements
  static constexpr int OWN = 64;             // the block's rows, 16 a warp
  static constexpr int STEP = D == 64 ? 64 : 32;  // rows of the walked tile
};

// Rows [r0, r0 + rows) of operand `op` into dst[rows][LD], 16 bytes a load;
// rows past T read as zero.
template <typename scalar_t, int D>
__device__ __forceinline__ void stage_tc(const Args& a, int op, int bh,
                                         int r0, int rows, scalar_t* dst) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  const scalar_t* src = static_cast<const scalar_t*>(a.in[op]);
  for (int i = threadIdx.x; i < rows * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < a.t_len)
      x = *reinterpret_cast<const uint4*>(src + row_off(a, op, bh, r0 + r) +
                                          8 * c);
    *reinterpret_cast<uint4*>(dst + r * TcTile<D>::LD + 8 * c) = x;
  }
}

// A fragments of rows [m0, m0 + 16), columns [k0, k0 + 16) of a [.][LD] tile
template <int D, typename scalar_t>
__device__ __forceinline__ void frag_a(uint32_t (&r)[4], const scalar_t* t,
                                       int m0, int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(r, t + (m0 + lane % 16) * TcTile<D>::LD + k0 + (lane / 16) * 8);
}

// B fragments of two n-blocks [n0, n0 + 16) x k [k0, k0 + 16), the tile
// stored [n][k] (rows are n): r[0..1] n-block n0, r[2..3] n-block n0 + 8
template <int D, typename scalar_t>
__device__ __forceinline__ void frag_b_nk(uint32_t (&r)[4], const scalar_t* t,
                                          int n0, int k0) {
  const int lane = threadIdx.x % 32, m = lane / 8;
  ldsm_x4(r, t + (n0 + lane % 8 + (m / 2) * 8) * TcTile<D>::LD + k0 +
                 (m % 2) * 8);
}

// the same, the tile stored [k][n] (rows are k): ldmatrix transposes
template <int D, typename scalar_t>
__device__ __forceinline__ void frag_b_kn(uint32_t (&r)[4], const scalar_t* t,
                                          int n0, int k0) {
  const int lane = threadIdx.x % 32, m = lane / 8;
  ldsm_x4_t(r, t + (k0 + lane % 8 + (m % 2) * 8) * TcTile<D>::LD + n0 +
                   (m / 2) * 8);
}

// acc[NB][4] (+)= A(16 x 16*KS, from c[2*KS][4] as hi + lo) x B, with B the
// tile t stored [k][n], k rows [0, 16*KS), n columns [0, 8*NB)
template <typename scalar_t, int D, int KS, int NB>
__device__ __forceinline__ void mma_regs_kn(float (&acc)[NB][4],
                                            const float (&c)[2 * KS][4],
                                            const scalar_t* t) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t hi[4], lo[4];
    Tc<scalar_t>::split(c[2 * kk][0], c[2 * kk][1], hi[0], lo[0]);
    Tc<scalar_t>::split(c[2 * kk][2], c[2 * kk][3], hi[1], lo[1]);
    Tc<scalar_t>::split(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[2], lo[2]);
    Tc<scalar_t>::split(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int n2 = 0; n2 < NB / 2; ++n2) {
      uint32_t b[4];
      frag_b_kn<D>(b, t, 16 * n2, 16 * kk);
      Tc<scalar_t>::mma(acc[2 * n2], hi, b[0], b[1]);
      Tc<scalar_t>::mma(acc[2 * n2], lo, b[0], b[1]);
      Tc<scalar_t>::mma(acc[2 * n2 + 1], hi, b[2], b[3]);
      Tc<scalar_t>::mma(acc[2 * n2 + 1], lo, b[2], b[3]);
    }
  }
}

// Store acc (16 rows of this warp from `row0`, D columns) times `mul`
template <typename scalar_t, int D>
__device__ __forceinline__ void store_rows(const Args& a, void* out, int bh,
                                           int row0, const float (&acc)[D / 8][4],
                                           float mul) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  scalar_t* o = static_cast<scalar_t*>(out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= a.t_len) continue;
    scalar_t* orow = o + (size_t(bh) * a.t_len + row) * D;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      orow[8 * nb + 2 * t] = from_f32<scalar_t>(acc[nb][2 * half] * mul);
      orow[8 * nb + 2 * t + 1] =
          from_f32<scalar_t>(acc[nb][2 * half + 1] * mul);
    }
  }
}

template <int D>
constexpr size_t tc_smem() {
  using TT = TcTile<D>;
  return sizeof(__half) * (2 * size_t(TT::OWN) + 2 * size_t(TT::STEP)) *
             TT::LD +
         sizeof(float) * 2 * TT::STEP;
}

template <typename scalar_t, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_tc_kernel(Args a) {
  using TT = TcTile<D>;
  constexpr int LD = TT::LD, OWN = TT::OWN, BQ = TT::STEP, NQ = BQ / 8,
                ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  scalar_t* ks = reinterpret_cast<scalar_t*>(smem_tc);  // [OWN][LD]
  scalar_t* vs = ks + OWN * LD;                           // [OWN][LD]
  scalar_t* qs = vs + OWN * LD;                           // [BQ][LD]
  scalar_t* gs = qs + BQ * LD;                            // [BQ][LD] dO
  float* lse_s = reinterpret_cast<float*>(gs + BQ * LD);  // [BQ]
  float* delta_s = lse_s + BQ;                            // [BQ]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, k0 = blockIdx.y * OWN;
  const int kw = 16 * warp;  // this warp's key rows in the tile
  stage_tc<scalar_t, D>(a, OP_K, bh, k0, OWN, ks);
  stage_tc<scalar_t, D>(a, OP_V, bh, k0, OWN, vs);

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int n_qb = (a.t_len + BQ - 1) / BQ;
  int qb = 0;
  if (a.causal) {
    const long long first =
        (long long)a.k_offset + k0 - (long long)a.q_offset;
    if (first >= a.t_len)
      qb = n_qb;
    else if (first > 0)
      qb = int(first / BQ);
  }
  for (; qb < n_qb; ++qb) {
    const int q0 = qb * BQ;
    __syncthreads();  // the previous tile's readers are done (K, V are in)
    stage_tc<scalar_t, D>(a, OP_Q, bh, q0, BQ, qs);
    stage_tc<scalar_t, D>(a, OP_DO, bh, q0, BQ, gs);
    for (int i = tid; i < BQ; i += NT) {
      const bool in = q0 + i < a.t_len;
      lse_s[i] = in ? a.lse[size_t(bh) * a.t_len + q0 + i] : 0.f;
      delta_s[i] = in ? a.delta[size_t(bh) * a.t_len + q0 + i] : 0.f;
    }
    __syncthreads();

    // s^T = K q^T and (dO v^T)^T = V dO^T: this warp's 16 keys x BQ queries
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      frag_a<D>(ka, ks, kw, 16 * kk);
      frag_a<D>(va, vs, kw, 16 * kk);
#pragma unroll
      for (int n2 = 0; n2 < NQ / 2; ++n2) {
        uint32_t qb4[4], gb4[4];
        frag_b_nk<D>(qb4, qs, 16 * n2, 16 * kk);
        frag_b_nk<D>(gb4, gs, 16 * n2, 16 * kk);
        Tc<scalar_t>::mma(s[2 * n2], ka, qb4[0], qb4[1]);
        Tc<scalar_t>::mma(s[2 * n2 + 1], ka, qb4[2], qb4[3]);
        Tc<scalar_t>::mma(dp[2 * n2], va, gb4[0], gb4[1]);
        Tc<scalar_t>::mma(dp[2 * n2 + 1], va, gb4[2], gb4[3]);
      }
    }
    // p^T and ds^T in place: element e of n-block n is key kw + g (+8 for
    // e >= 2), query 8 n + 2 t + (e & 1)
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + kw + g + (e >> 1) * 8;
        const int qi = 8 * n + 2 * t + (e & 1);
        const float p = visible(a, q0 + qi, key)
                            ? expf(s[n][e] * a.scale - lse_s[qi]) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - delta_s[qi]);
      }
    // dv += p^T dO and dk += ds^T q over the tile's queries
    mma_regs_kn<scalar_t, D, BQ / 16, ND>(dv, s, gs);
    mma_regs_kn<scalar_t, D, BQ / 16, ND>(dk, dp, qs);
  }
  store_rows<scalar_t, D>(a, a.dk, bh, k0 + kw, dk, a.scale);
  store_rows<scalar_t, D>(a, a.dv, bh, k0 + kw, dv, 1.f);
}

template <typename scalar_t, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_tc_kernel(Args a) {
  using TT = TcTile<D>;
  constexpr int LD = TT::LD, OWN = TT::OWN, BK = TT::STEP, NK = BK / 8,
                ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  scalar_t* qs = reinterpret_cast<scalar_t*>(smem_tc);  // [OWN][LD]
  scalar_t* gs = qs + OWN * LD;                           // [OWN][LD] dO
  scalar_t* ks = gs + OWN * LD;                           // [BK][LD]
  scalar_t* vs = ks + BK * LD;                            // [BK][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  // the last Q tile, which sees the most K tiles, first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * OWN;
  const int qw = 16 * warp;  // this warp's query rows in the tile
  stage_tc<scalar_t, D>(a, OP_Q, bh, q0, OWN, qs);
  stage_tc<scalar_t, D>(a, OP_DO, bh, q0, OWN, gs);
  float lse[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + qw + g + 8 * h;
    const bool in = row < a.t_len;
    lse[h] = in ? a.lse[size_t(bh) * a.t_len + row] : 0.f;
    delta[h] = in ? a.delta[size_t(bh) * a.t_len + row] : 0.f;
  }
  __syncthreads();
  uint32_t qa[D / 16][4], ga[D / 16][4];  // this warp's rows, kept
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    frag_a<D>(qa[kk], qs, qw, 16 * kk);
    frag_a<D>(ga[kk], gs, qw, 16 * kk);
  }

  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  int n_kb = (a.t_len + BK - 1) / BK;
  if (a.causal) {
    const int last_q = q0 + min(OWN, a.t_len - q0) - 1;
    const long long last_key =
        (long long)a.q_offset + last_q - (long long)a.k_offset;
    if (last_key < 0)
      n_kb = 0;
    else if (last_key / BK + 1 < n_kb)
      n_kb = int(last_key / BK + 1);
  }
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tile's readers are done
    stage_tc<scalar_t, D>(a, OP_K, bh, k0, BK, ks);
    stage_tc<scalar_t, D>(a, OP_V, bh, k0, BK, vs);
    __syncthreads();

    // s = q K^T and dO V^T: this warp's 16 queries x BK keys
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < NK / 2; ++n2) {
        uint32_t kb4[4], vb4[4];
        frag_b_nk<D>(kb4, ks, 16 * n2, 16 * kk);
        frag_b_nk<D>(vb4, vs, 16 * n2, 16 * kk);
        Tc<scalar_t>::mma(s[2 * n2], qa[kk], kb4[0], kb4[1]);
        Tc<scalar_t>::mma(s[2 * n2 + 1], qa[kk], kb4[2], kb4[3]);
        Tc<scalar_t>::mma(dp[2 * n2], ga[kk], vb4[0], vb4[1]);
        Tc<scalar_t>::mma(dp[2 * n2 + 1], ga[kk], vb4[2], vb4[3]);
      }
    }
    // ds in place: element e of n-block n is query qw + g (+8 for e >= 2),
    // key 8 n + 2 t + (e & 1)
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int key = k0 + 8 * n + 2 * t + (e & 1);
        const float p = visible(a, q0 + qw + g + 8 * h, key)
                            ? expf(s[n][e] * a.scale - lse[h]) : 0.f;
        dp[n][e] = p * (dp[n][e] - delta[h]);
      }
    // dq += ds K over the tile's keys
    mma_regs_kn<scalar_t, D, BK / 16, ND>(dq, dp, ks);
  }
  store_rows<scalar_t, D>(a, a.dq, bh, q0 + qw, dq, a.scale);
}

template <typename scalar_t, int D>
cudaError_t launch_tc(const Args& a, int bh, cudaStream_t stream) {
  auto dkdv = flash_bwd_dkdv_tc_kernel<scalar_t, D>;
  auto dq = flash_bwd_dq_tc_kernel<scalar_t, D>;
  constexpr size_t smem = tc_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  const int rows = bh * a.t_len;
  flash_bwd_delta_kernel<scalar_t>
      <<<(rows + NT / 32 - 1) / (NT / 32), NT, 0, stream>>>(a, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (a.t_len + TcTile<D>::OWN - 1) / TcTile<D>::OWN);
  dkdv<<<grid, NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
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

// The tensor-core route, with flash_attn_bwd's arguments: dtype 1 or 2,
// d 64 or 128, every stride in `strides` a multiple of 8 elements and
// every operand 16-byte aligned (the caller checks; see
// ops/kernels.py:_flash_bwd_route).
extern "C" int flash_attn_bwd_tc(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, const void* dlse,
                                 void* delta, void* dq, void* dk, void* dv,
                                 const long long* strides, int batch,
                                 int heads, int t_len, int d, int dtype,
                                 float scale, int causal, int q_offset,
                                 int k_offset, void* stream) {
  if (bad_size(batch, heads, t_len, d) || (d != 64 && d != 128))
    return int(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, o, dout, lse, dlse, delta, dq, dk, dv,
                           strides, heads, t_len, d, scale, causal, q_offset,
                           k_offset);
  const int bh = batch * heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 1000 + d) {
    case 1064:
      return int(launch_tc<__nv_bfloat16, 64>(a, bh, s));
    case 1128:
      return int(launch_tc<__nv_bfloat16, 128>(a, bh, s));
    case 2064:
      return int(launch_tc<__half, 64>(a, bh, s));
    case 2128:
      return int(launch_tc<__half, 128>(a, bh, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
