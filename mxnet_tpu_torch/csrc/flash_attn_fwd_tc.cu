// Flash-attention forward on Hopper's tensor cores (sm_90a): kernel K1,
// tensor-core route.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py:_mha_kernel
// (:47), built by _build_flash (:119, the pl.pallas_call at :149) and
// entered through flash_attention (:173). It computes the same function as
// flash_attn_fwd.cu, the CUDA-core route, which stays for fp32 and for
// what this kernel does not take: for q, k, v (B, H, T, D) of one 16-bit
// dtype,
//   s   = scale * (q k^T)              (scaled in f32, after the product)
//   s   = -inf where causal and q_offset + i < k_offset + j, or j >= T
//   O   = softmax(s) v                 (rounded to the input dtype)
//   lse = m + log(max(l, 1e-20))       (f32, m = row max, l = row sum)
// A row with no visible key gives O = 0 and lse = -1e30 + log(1e-20).
//
// Takes: bf16 and fp16; D in {64, 128}; q, k, v whose last dimension has
// stride 1, whose other strides are multiples of 8 elements and whose base
// addresses are 16-byte aligned (ops/kernels.py:_flash_route). So the
// LM's q/k/v are read in place as strided views of the qkv projection's
// output. O is written into (B, T, H, D) memory, so the heads merge for
// free; lse into contiguous f32 (B, H, T).
//
// Bound on the H100 SXM at the LM's shape (8, 12, 1024, 64) bf16 causal:
// 1.29e10 FLOP is 13 us at 989 TFLOP/s; q, k, v read once, O and lse
// written once are 50.7 MB, 15 us at 3.35 TB/s. So bytes bound it.
//
// Design.
// - One CTA of 288 threads owns BQ = 128 query rows of one (batch, head):
//   two consumer warpgroups of 64 rows each and one producer warp. The
//   grid is (B * H, ceil(T / BQ)); blockIdx.y = 0 takes the last Q tile,
//   so under causal masking the heaviest tiles are dispatched first.
// - Q, K and V arrive by TMA, one 4-D tensor map each (D, T, H, B in the
//   order of increasing stride) built on the host from the tensors' own
//   strides, into 128-byte-swizzled tiles: one panel of 64 columns (128
//   bytes a row) per 64 of D. K/V go through a ring of STAGES = 3 stages
//   guarded by full/empty mbarriers, so the next tiles' loads overlap
//   this tile's math. TMA zero-fills rows past T; those columns are masked.
// - S = Q K^T is wgmma m64nBKk16 with both operands in shared memory (K's
//   [BK][D] tile is K-major for the B operand), accumulated in f32.
// - The online softmax runs on the f32 accumulator fragment in log2
//   units (scale * log2(e) applied to the f32 scores, exp2); row max and
//   row sum reduce over the fragment's quad with two xor shuffles.
// - O += P V is wgmma with A = P from registers: the f32 S fragment maps
//   onto the 16-bit A-operand fragment pair by pair. P is split into
//   hi + lo in the input dtype (for bf16, hi is the top 16 bits of each
//   f32 by a bit mask), and both go through the product, so ~16 bits of
//   each probability survive: P rounded once put O 9 output ulps off where
//   |O| is small, the split keeps it within 1 ulp for 1.5x the
//   tensor-core work and 13 % more time. l is summed from the unrounded
//   p. V's [BK][D] tile is MN-major for this product (transpose flag
//   set), so V is never transposed in memory.
// - Causal: K tiles wholly in the future of the CTA's rows are never
//   loaded, a warpgroup skips the math of a tile wholly in its rows'
//   future, and only tiles that cross the diagonal (or T) are masked.
// - Epilogue: O = acc / max(l, 1e-20) stored from registers with a bounds
//   check on the row; lse by one thread of each quad.
//
// Tiles: BQ = 128, BK = 64. Shared memory: Q 16 KB + 3 x (K 8 KB + V
// 8 KB) = 64 KB for D = 64, two CTAs per SM, which leaves 96 registers a
// thread; Q 32 KB + 3 x (16 + 16) KB = 128 KB for D = 128, one CTA per
// SM. ptxas: 96 registers for D = 64 and 163-167 for D = 128, no spills
// (chip_smoke.py phase a prints and checks it).
//
// What holds it back (tools/torch_k1_variants.py times the variants on
// the H100): each warpgroup runs Q K^T, waits, runs the softmax, runs
// P.V, waits, so its products and its softmax never overlap; the four
// warpgroups of an SM overlap each other only as far as their phases
// drift apart. Leaving out all P.V products saves under a fifth of the
// time. Tiles of 128 keys (one CTA per SM, 167 registers) are slower; so
// were, in probes not kept, a persistent kernel with QK(i+1) issued
// before the softmax of tile i (one CTA per SM) and turns taken between
// the two warpgroups on named barriers (spills at 96 registers). The
// next step is warpgroups with setmaxnreg-raised register budgets, so
// that the overlap fits without giving up warps per SM.
#include <math.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int BQ = 128;                 // query rows per CTA
constexpr int CONSUMERS = 2;            // consumer warpgroups, 64 rows each
constexpr int NT = CONSUMERS * 128 + 32;  // + one producer warp
constexpr int STAGES = 3;               // K/V ring depth
constexpr float NEG = -1e30f;           // the TPU kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int MAX_Q_TILES = 65535;      // gridDim.y

template <int D> struct Tiles;
// BK: key rows per K/V tile. MIN_BLOCKS: CTAs per SM that the register
// budget must allow; two CTAs of 9 warps leave 96 registers a thread.
template <> struct Tiles<64> {
  static constexpr int BK = 64, MIN_BLOCKS = 2;
};
template <> struct Tiles<128> {
  static constexpr int BK = 64, MIN_BLOCKS = 1;
};

template <int D>
constexpr int smem_bytes() {
  // Q, then the K stages, then the V stages, then 2 * STAGES + 1 mbarriers;
  // plus 1 KB to align the tiles to the 1024-byte swizzle atom
  return BQ * D * 2 + 2 * STAGES * Tiles<D>::BK * D * 2 +
         (2 * STAGES + 1) * 8 + 1024;
}

// The accumulator fragment and its map to the A fragment of the next
// product, which is how P is packed: hopper.cuh.
template <typename scalar_t, int D>
__global__ void __launch_bounds__(NT, Tiles<D>::MIN_BLOCKS)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    scalar_t* __restrict__ o, float* __restrict__ lse,
                    int n_heads, int t_len, float scale_log2, int causal,
                    int q_offset, int k_offset, int qpos, int kpos,
                    int vpos) {
  constexpr int BK = Tiles<D>::BK;
  constexpr int NP = D / PANEL;                    // 64-column panels
  constexpr int Q_PANEL = BQ * ROW_BYTES;
  constexpr int KV_PANEL = BK * ROW_BYTES;
  constexpr int KV_BYTES = NP * KV_PANEL;
  constexpr bool F16 = std::is_same<scalar_t, __half>::value;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sk = sq + NP * Q_PANEL;
  uint8_t* sv = sk + STAGES * KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sv + STAGES * KV_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh % n_heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first

  // Key j is visible to query row i when i + shift >= j. Rows and keys
  // are below 2^23 (at most 65535 Q tiles), so clamping the offsets'
  // difference to +-2^25 changes no comparison and keeps them in int.
  const int shift = int(max(-(1LL << 25), min(1LL << 25, (long long)q_offset -
                                                             k_offset)));
  // K tiles to visit: all, or under causal masking those holding a key
  // visible to some row of this Q tile.
  int n_kb = (t_len + BK - 1) / BK;
  if (causal) {
    const int last_key = q0 + min(BQ, t_len - q0) - 1 + shift;
    if (last_key < 0)
      n_kb = 0;
    else if (last_key / BK + 1 < n_kb)
      n_kb = last_key / BK + 1;
  }

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);   // one arrival per warp
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == CONSUMERS * 4) {
    // ---- producer: one thread keeps the TMA loads in flight
    if (lane != 0 || n_kb == 0) return;
    int c1, c2, c3;
    mbar_expect_tx(qbar, NP * Q_PANEL);
    coords(qpos, q0, h, b, c1, c2, c3);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      tma_load(sq + p * Q_PANEL, &tq, qbar, p * PANEL, c1, c2, c3);
    for (int i = 0; i < n_kb; ++i) {
      const int s = i % STAGES, use = i / STAGES;
      if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
      mbar_expect_tx(&full[s], 2 * KV_BYTES);
      int k1, k2, k3, v1, v2, v3;
      coords(kpos, i * BK, h, b, k1, k2, k3);
      coords(vpos, i * BK, h, b, v1, v2, v3);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        tma_load(sk + s * KV_BYTES + p * KV_PANEL, &tk, &full[s], p * PANEL,
                 k1, k2, k3);
        tma_load(sv + s * KV_BYTES + p * KV_PANEL, &tv, &full[s], p * PANEL,
                 v1, v2, v3);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. q0 + 64 wg + 63
  const int wg = warp / 4, w = warp % 4;
  const int g = lane / 4, c = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * w + g;       // and row0 + 8
  const int last_seen = q0 + 64 * wg + shift;   // last key of its row 0
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};   // m in log2 units

  if (n_kb > 0) mbar_wait(qbar, 0);
  const uint8_t* qw = sq + 64 * wg * ROW_BYTES;
  for (int i = 0; i < n_kb; ++i) {
    const int s = i % STAGES;
    const int k0 = i * BK;
    mbar_wait(&full[s], (i / STAGES) & 1);
    // a tile wholly in the causal future of this warpgroup's rows
    const bool skip = causal && k0 > last_seen + 63;
    if (!skip) {
      const uint8_t* kt = sk + s * KV_BYTES;
      const uint8_t* vt = sv + s * KV_BYTES;
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk % 4) * 32;   // 16 columns = 32 bytes
        wgmma_ss<BK, F16, 0>(
            sc, sw128_desc(qw + (kk / 4) * Q_PANEL + off, 16, 1024),
            sw128_desc(kt + (kk / 4) * KV_PANEL + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin<BK / 2>(sc);

      const bool unmasked =
          k0 + BK <= t_len &&
          (!causal || k0 + BK - 1 <= last_seen);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (!unmasked) {
            const int col = k0 + 8 * j + 2 * c + (e & 1);
            const bool ok = col < t_len &&
                            (!causal || row0 + 8 * (e >> 1) + shift >= col);
            x = ok ? x : -INFINITY;
          }
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);   // finite: m starts at NEG
        corr[r] = fast_exp2(m[r] - m_new);
        m[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(sc[4 * j + e] - m[e >> 1]);  // masked: 0
          rs[e >> 1] += p;
          sc[4 * j + e] = p;
        }
      // P = hi + lo in the input dtype (see the header)
      uint32_t phi[BK / 16][4], plo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          split2<scalar_t>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1],
                           phi[kk][r], plo[kk][r]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];

      pin<D / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = sw128_desc(vt + kk * 16 * ROW_BYTES, KV_PANEL,
                                       1024);
        wgmma_rs<D, F16>(acc, phi[kk], dv);
        wgmma_rs<D, F16>(acc, plo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin<D / 2>(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // ---- epilogue: each row's sum over its quad, then O and lse
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= t_len) continue;
    const float lc = fmaxf(l[r], 1e-20f);
    const float inv = 1.f / lc;
    scalar_t* orow = o + ((size_t(b) * t_len + row) * n_heads + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * c) = pack2<scalar_t>(
          acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    if (c == 0)
      lse[size_t(bh) * t_len + row] =
          (m[r] == NEG ? NEG : m[r] * LN2) + logf(lc);
  }
}

template <typename scalar_t, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int h, int t, const long long* st, float scale, int causal,
           int q_offset, int k_offset, cudaStream_t stream) {
  constexpr bool f16 = std::is_same<scalar_t, __half>::value;
  constexpr int BK = Tiles<D>::BK;
  CUtensorMap tq, tk, tv;
  int qpos, kpos, vpos, err;
  if ((err = make_map(&tq, q, f16, D, t, h, b, st[2], st[1], st[0], BQ,
                      &qpos)) ||
      (err = make_map(&tk, k, f16, D, t, h, b, st[5], st[4], st[3], BK,
                      &kpos)) ||
      (err = make_map(&tv, v, f16, D, t, h, b, st[8], st[7], st[6], BK,
                      &vpos)))
    return err;
  constexpr int smem = smem_bytes<D>();
  auto kernel = flash_fwd_tc_kernel<scalar_t, D>;
  static unsigned long long attr_set = 0;   // one bit per device
  if ((err = allow_smem(kernel, smem, attr_set))) return err;
  dim3 grid(b * h, (t + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(
      tq, tk, tv, static_cast<scalar_t*>(o), static_cast<float*>(lse), h, t,
      scale * LOG2E, causal, q_offset, k_offset, qpos, kpos, vpos);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 1 bfloat16, 2 float16; d: 64 or 128. q, k, v are (b, h, t, d)
// with unit stride in d; strides holds their element strides over
// (b, h, t): q's three, then k's, then v's. o is contiguous (b, t, h, d);
// lse contiguous f32 (b, h, t). Launches on `stream`, never synchronises,
// and returns 0, a cudaError_t, or one of hopper.cuh's ERR_* codes.
extern "C" int flash_attn_fwd_tc(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int b, int h, int t,
                                 int d, const long long* strides, int dtype,
                                 float scale, int causal, int q_offset,
                                 int k_offset, void* stream) {
  if (b <= 0 || h <= 0 || t <= 0 || (long long)b * h > 0x7fffffffLL ||
      (t + BQ - 1) / BQ > MAX_Q_TILES)
    return ERR_SHAPE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, b, h, t, strides,
                                     scale, causal, q_offset, k_offset, s);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, b, h, t, strides,
                                      scale, causal, q_offset, k_offset, s);
  if (dtype == 2 && d == 64)
    return launch<__half, 64>(q, k, v, o, lse, b, h, t, strides, scale,
                              causal, q_offset, k_offset, s);
  if (dtype == 2 && d == 128)
    return launch<__half, 128>(q, k, v, o, lse, b, h, t, strides, scale,
                               causal, q_offset, k_offset, s);
  return ERR_SHAPE;
}

extern "C" const char* flash_attn_fwd_tc_error_string(int err) {
  switch (err) {
    case ERR_NO_ENCODER:
      return "cuTensorMapEncodeTiled is not available from the driver";
    case ERR_ENCODE:
      return "cuTensorMapEncodeTiled refused a tensor map (strides or "
             "base address not 16-byte aligned?)";
    case ERR_SHAPE:
      return "shape, dtype or head dimension the tensor-core kernel does "
             "not take";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}
