// Flash-attention backward on Hopper's tensor cores (sm_90a): kernel K2,
// tensor-core route.
//
// Replaces mxnet_tpu/ops/pallas_kernels.py:_flash_bwd_blockwise (:241), the
// backward that flash_attention_with_grad (:347) and flash_attention_with_lse
// (:300) pair with the Pallas forward (K1); there it is a lax.scan over K
// blocks. It computes what flash_attn_bwd.cu, the CUDA-core route, computes
// (that source stays for fp32 and the other head dimensions): for q, k, v,
// O, dO (B, H, T, D) of one 16-bit dtype, K1's f32 row log-sum-exp lse and,
// optionally, its cotangent dlse,
//   delta = rowsum(dO * O) - dlse                  (f32, one per row)
//   p     = exp(scale * q k^T - lse), exactly 0 where the key is masked
//   ds    = p * (dO v^T - delta)
//   dq    = scale * ds k,  dk = scale * ds^T q,  dv = p^T dO
// with every sum in f32 and the results stored in the input dtype. Key j is
// visible to query i when both lie inside T and, under causal masking,
// q_offset + i >= k_offset + j (K1's rule). A row that sees no key (only
// possible with offsets) has p = 0 throughout: its dq is exactly 0 and it
// adds nothing to dk or dv.
//
// Takes: bf16 and fp16; D in {64, 128}; q, k, v, O, dO with unit stride in
// D, every other stride a multiple of 8 elements and 16-byte-aligned bases
// (ops/kernels.py:_flash_bwd_route), read in place through their own
// (batch, head, row) strides: the LM's q/k/v views of the qkv projection,
// K1's (B, T, H, D)-memory O and autograd's strided dO cost no copy. dq,
// dk and dv are written through their own (batch, head, row) strides, so
// the LM's three gradients land in one (B, T, 3H, D) buffer.
//
// Bound on the H100 SXM at the LM's shape (8, 12, 1024, 64) bf16 causal:
// the five T x T x D products over the visible half are 3.22e10 FLOP,
// 0.0326 ms at 989 TFLOP/s; q, k, v, O, dO read once and dq, dk, dv
// written once are 101 MB, 0.0302 ms at 3.35 TB/s. Bound by operations.
//
// Design.
// - A pre-pass (one warp per row) writes delta and lse * log2(e) into f32
//   rows padded to a multiple of 128, which the main kernels load by bulk
//   copy.
// - dk/dv kernel: one CTA per (batch * head, 64 keys): one consumer
//   warpgroup and one producer warp, two CTAs per SM at D = 64. K and V
//   of the tile arrive once by TMA and stay. Q, dO, lse and delta tiles of BQ
//   queries stream through a ring of STAGES stages guarded by full/empty
//   mbarriers; only the query tiles that can see a key of the tile are
//   loaded (under causal masking, from the tile's first visible row on).
//   S^T = K Q^T and dP^T = V dO^T are wgmma with both operands K-major in
//   128-byte-swizzled shared memory. p^T and ds^T are formed on the f32
//   accumulator fragment, which maps onto the 16-bit A fragment of the
//   next product (hopper.cuh), so dV += p^T dO and dK += ds^T Q are wgmma
//   with A from registers and B the streamed dO or Q tile read MN-major
//   (the transpose flag): no tile is transposed in memory. ds^T is split
//   into its A fragments while the dV products run.
// - dq kernel: one CTA per (batch * head, 64 Q_WGS queries), K1's shape
//   (Q_WGS consumer warpgroups of 64 rows, one at D = 64, two at
//   D = 128, and a producer warp): Q and dO resident, K and V tiles of
//   64 keys streamed by TMA through the ring, heaviest query tiles
//   first. S = Q K^T and dP = dO V^T are SS wgmma, ds is formed on the
//   fragment, dQ += ds K is RS wgmma with K read MN-major.
// - Accuracy: p^T, ds^T and ds go through their products as hi + lo terms
//   in the input dtype (two RS wgmma on the same B tile, as K1's P.V), so
//   ~16 bits of each survive: p rounded once to bf16 reads ~17 output ulps
//   on dv at the LM's shape, the split holds the 4-ulp limit that
//   chip_smoke.py phase b checks.
// - Determinism: no float atomics. Every output element is written by one
//   CTA, so a second launch is bitwise equal. That is why dq has its own
//   kernel, which recomputes S and dP: FlashAttention-3's atomic dQ
//   accumulation is not taken, nor a per-key-tile f32 dQ workspace
//   (8 x 25 MB at the LM's shape).
// - Causal: a warpgroup skips the math of a tile wholly in its keys' past
//   (dk/dv) or its rows' future (dq); only tiles that cross the diagonal
//   or T are masked element by element.
// - Epilogue: each warpgroup stores its 64 rows from the f32 fragment with
//   a bounds check on the row, through the output's strides.
//
// Tensor-core work really issued at the LM's shape: the dk/dv kernel runs
// 272 (64-key, 32-query) tile pairs per (batch, head), six 64 x 32 x 64
// products each (S^T, dP^T, two for dV, two for dK); the dq kernel 136
// (64-query, 64-key) pairs, four 64^3 products each (S, dP, two for dQ).
// 6.85e10 FLOP in all (chip_smoke.py:k2_issued_flops walks the same
// tiles), 2.12x the five-product bound: the recomputed S and dP of the dq
// kernel, the three hi + lo doublings and the masked halves of the
// diagonal tiles.
//
// Tiles and registers (Cfg): dk/dv streams BQ = 32 queries a tile. A
// thread holds dK and dV (D / 2 f32 registers each), the S^T and dP^T
// fragments (BQ / 2 each) and their 16-bit splits: 144 registers at
// D = 64, 208 at D = 128; the dq kernel 146 and 168 (bf16). ptxas must
// report no spill (chip_smoke.py phase a). Shared memory: dk/dv K, V
// 2 x 64 x D x 2 bytes + 4 stages x (Q, dO 2 x 32 x D x 2 + lse, delta
// 2 x 32 x 4); dq Q, dO 2 x 64 Q_WGS x D x 2 + 3 stages x (K, V
// 2 x 64 x D x 2).
//
// What holds it back: two consumer warpgroups per SM; each runs its S
// and dP products, waits, forms p and ds (ds^T is split while the dV
// products run), runs the dV / dK (or dQ) products and waits, so its
// products barely overlap its own exponentials, and the warpgroups of an
// SM overlap each other only as far as their phases drift apart. The
// issued work is 2.12x the bound. Measured variants (tools/
// torch_k2_variants.py, PERF.md): 2 stages, 64-query dk/dv tiles, two
// warpgroups a CTA and an S / dP split into two commit groups were all
// slower; p and ds rounded once to 16 bits (no lo terms) are 13 % faster
// and 21 ulps off.
#include <math.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int PAD = 128;                    // lse, delta rows padded to this
constexpr int BK = 64;                      // keys per streamed tile (dq)
constexpr int PREP_NT = 128;                // pre-pass threads, a warp a row
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_TILES = 65535;            // gridDim.y

template <int D> struct Cfg;
// BQ: queries per streamed tile of the dk/dv kernel, also the rows of
// every TMA box. KV_WGS, Q_WGS: consumer warpgroups (64 rows each) of a
// dk/dv and a dq CTA. KV_STAGES, Q_STAGES: their ring depths.
// One consumer warpgroup a CTA (5 warps, up to 255 registers) lets two
// CTAs share an SM where a thread needs at most 168 registers (three warps
// on one of the SM's four register-file quarters); tools/
// torch_k2_variants.py measured it 3 % faster than two warpgroups a CTA
// at the LM's shape. A 9-warp CTA caps a thread at 168, which dK and dV
// (D registers) leave too few of at D = 128.
template <> struct Cfg<64> {
  static constexpr int BQ = 32, KV_WGS = 1, KV_STAGES = 4;
  static constexpr int Q_WGS = 1, Q_STAGES = 3;
};
template <> struct Cfg<128> {
  static constexpr int BQ = 32, KV_WGS = 1, KV_STAGES = 4;
  static constexpr int Q_WGS = 2, Q_STAGES = 3;
};
template <int D>
__host__ __device__ constexpr int kv_threads() {
  return Cfg<D>::KV_WGS * 128 + 32;   // + one producer warp
}
template <int D>
__host__ __device__ constexpr int kv_rows() { return Cfg<D>::KV_WGS * 64; }
template <int D>
__host__ __device__ constexpr int q_threads() {
  return Cfg<D>::Q_WGS * 128 + 32;
}
template <int D>
__host__ __device__ constexpr int q_rows() { return Cfg<D>::Q_WGS * 64; }

struct Params {
  const float* lse2;      // (B*H, t_pad): lse * log2(e)
  const float* delta;     // (B*H, t_pad)
  void* out[3];           // dq, dk, dv
  long long ost[3][3];    // their (batch, head, row) element strides
  int heads, t_len, t_pad;
  float scale, scale_log2;
  int causal, shift;      // shift = q_offset - k_offset, clamped
  int qpos, kpos, vpos, dopos;   // tensor-map positions (see coords)
};

template <int D>
constexpr int dkdv_smem() {
  constexpr int BQ = Cfg<D>::BQ, S = Cfg<D>::KV_STAGES;
  // K, V; the Q, dO stages; the lse, delta stages; 2 S + 1 mbarriers; and
  // 1 KB to align the tiles to the 1024-byte swizzle atom
  return 2 * kv_rows<D>() * D * 2 + 2 * S * BQ * D * 2 + 2 * S * BQ * 4 +
         (2 * S + 1) * 8 + 1024;
}

template <int D>
constexpr int dq_smem() {
  constexpr int S = Cfg<D>::Q_STAGES;
  return 2 * q_rows<D>() * D * 2 + 2 * S * BK * D * 2 + (2 * S + 1) * 8 +
         1024;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// `rows` rows (a multiple of BQ) from row t of (b, h) into a tile of `rows`
// rows per 64-column panel, BQ rows a TMA box.
template <int D>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int pos, int t,
                                          int h, int b, int rows) {
  constexpr int BQ = Cfg<D>::BQ;
  for (int p = 0; p < D / PANEL; ++p)
    for (int r = 0; r < rows; r += BQ) {
      int c1, c2, c3;
      coords(pos, t + r, h, b, c1, c2, c3);
      tma_load(dst + (p * rows + r) * ROW_BYTES, map, bar, p * PANEL, c1, c2,
               c3);
    }
}

// Rows row0 and row0 + 8 of this thread's fragment (D / 2 f32, see
// hopper.cuh) times `mul`, stored through out's strides where row < T.
template <typename T, int D>
__device__ __forceinline__ void store_rows(const Params& p, int which, int b,
                                           int h, int row0, const float* acc,
                                           float mul) {
  const int c = threadIdx.x % 4;
  const long long* st = p.ost[which];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.t_len) continue;
    T* o = static_cast<T*>(p.out[which]) + b * st[0] + h * st[1] +
           row * st[2] + 2 * c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(o + 8 * j) =
          pack2<T>(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// delta[r] = sum_d dO[r, d] O[r, d] - dlse[r] and lse2[r] = lse[r] log2(e)
// for the rows of (B*H, t_pad); rows past T get 0 (their keys and queries
// are masked wherever they are read).
template <typename T>
__global__ void __launch_bounds__(PREP_NT)
flash_bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dlse, float* lse2,
                      float* delta, long long osb, long long osh,
                      long long ost, long long gsb, long long gsh,
                      long long gst, int heads, int t_len, int t_pad, int d,
                      int rows) {
  const int r = blockIdx.x * (PREP_NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int bh = r / t_pad, i = r % t_pad;
  if (i >= t_len) {
    if (lane == 0) lse2[r] = delta[r] = 0.f;
    return;
  }
  const int b = bh / heads, h = bh % heads;
  const T* orow = o + b * osb + h * osh + i * ost;
  const T* grow = dout + b * gsb + h * gsh + i * gst;
  float s = 0.f;
  for (int k = 2 * lane; k < d; k += 64) {
    float2 x, y;
    if constexpr (std::is_same<T, __half>::value) {
      x = __half22float2(*reinterpret_cast<const __half2*>(orow + k));
      y = __half22float2(*reinterpret_cast<const __half2*>(grow + k));
    } else {
      using B2 = __nv_bfloat162;
      x = __bfloat1622float2(*reinterpret_cast<const B2*>(orow + k));
      y = __bfloat1622float2(*reinterpret_cast<const B2*>(grow + k));
    }
    s = fmaf(x.x, y.x, fmaf(x.y, y.y, s));
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) {
    const size_t src = size_t(bh) * t_len + i;
    delta[r] = s - (dlse ? dlse[src] : 0.f);
    lse2[r] = lse[src] * LOG2E;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kv_threads<D>(), 1)
flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const Params p) {
  constexpr int BQ = Cfg<D>::BQ, STAGES = Cfg<D>::KV_STAGES;
  constexpr int WGS = Cfg<D>::KV_WGS, ROWS = kv_rows<D>();
  constexpr int NP = D / PANEL;                 // 64-column panels
  constexpr int KV_PANEL = ROWS * ROW_BYTES;    // resident K or V
  constexpr int KV_BYTES = NP * KV_PANEL;
  constexpr int S_PANEL = BQ * ROW_BYTES;       // a streamed Q or dO tile
  constexpr int S_BYTES = NP * S_PANEL;
  constexpr bool F16 = std::is_same<T, __half>::value;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = align1024(smem_raw);
  uint8_t* sv = sk + KV_BYTES;
  uint8_t* sq = sv + KV_BYTES;                  // STAGES tiles
  uint8_t* sdo = sq + STAGES * S_BYTES;         // STAGES tiles
  float* slse = reinterpret_cast<float*>(sdo + STAGES * S_BYTES);
  float* sdelta = slse + STAGES * BQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(sdelta + STAGES * BQ);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;

  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh % p.heads;
  const int k0 = blockIdx.y * ROWS;  // tile 0, seen by the most queries, first
  const int t_len = p.t_len;
  // Query tiles that can see a key of this tile: all, or under causal
  // masking those from the first row i with i + shift >= k0 on.
  const int n_qb = (t_len + BQ - 1) / BQ;
  int qb0 = 0;
  if (p.causal) {
    const int first = k0 - p.shift;
    qb0 = first <= 0 ? 0 : first >= t_len ? n_qb : first / BQ;
  }
  const int n_it = n_qb - qb0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WGS * 4);   // one arrival per consumer warp
    }
    mbar_init(kvbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == WGS * 4) {
    // ---- producer: one thread keeps the TMA loads in flight
    if (lane != 0 || n_it == 0) return;
    mbar_expect_tx(kvbar, 2 * KV_BYTES);
    load_rows<D>(sk, &tk, kvbar, p.kpos, k0, h, b, ROWS);
    load_rows<D>(sv, &tv, kvbar, p.vpos, k0, h, b, ROWS);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % STAGES, use = it / STAGES;
      const int q0 = (qb0 + it) * BQ;
      if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
      mbar_expect_tx(&full[s], 2 * S_BYTES + 2 * BQ * 4);
      load_rows<D>(sq + s * S_BYTES, &tq, &full[s], p.qpos, q0, h, b, BQ);
      load_rows<D>(sdo + s * S_BYTES, &tdo, &full[s], p.dopos, q0, h, b, BQ);
      const size_t row = size_t(bh) * p.t_pad + q0;
      bulk_load(slse + s * BQ, p.lse2 + row, BQ * 4, &full[s]);
      bulk_load(sdelta + s * BQ, p.delta + row, BQ * 4, &full[s]);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys kw0 .. kw0 + 63
  const int wg = warp / 4, w = warp % 4;
  const int g = lane / 4, c = lane % 4;
  const int kw0 = k0 + 64 * wg;
  const int key0 = kw0 + 16 * w + g;            // and key0 + 8
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  if (n_it > 0) mbar_wait(kvbar, 0);
  const uint8_t* kw = sk + 64 * wg * ROW_BYTES;
  const uint8_t* vw = sv + 64 * wg * ROW_BYTES;
  for (int it = 0; it < n_it; ++it) {
    const int s = it % STAGES;
    const int q0 = (qb0 + it) * BQ;
    mbar_wait(&full[s], (it / STAGES) & 1);
    // a query tile wholly in the causal past of this warpgroup's keys
    const bool skip = p.causal && q0 + BQ - 1 + p.shift < kw0;
    if (!skip) {
      const uint8_t* qt = sq + s * S_BYTES;
      const uint8_t* dot = sdo + s * S_BYTES;
      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * KV_PANEL + (kk % 4) * 32;
        const int soff = (kk / 4) * S_PANEL + (kk % 4) * 32;
        wgmma_ss<BQ, F16, 0>(st, sw128_desc(kw + off, 16, 1024),
                             sw128_desc(qt + soff, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * KV_PANEL + (kk % 4) * 32;
        const int soff = (kk / 4) * S_PANEL + (kk % 4) * 32;
        wgmma_ss<BQ, F16, 0>(dpt, sw128_desc(vw + off, 16, 1024),
                             sw128_desc(dot + soff, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin<BQ / 2>(st);
      pin<BQ / 2>(dpt);

      // p^T and ds^T in place: register 4j + e is key key0 + 8 (e / 2),
      // query q0 + 8j + 2c + e % 2
      const float* ls = slse + s * BQ;
      const float* dl = sdelta + s * BQ;
      const bool unmasked =
          q0 + BQ <= t_len && kw0 + 64 <= t_len &&
          (!p.causal || q0 + p.shift >= kw0 + 63);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * c + (e & 1);
          float pr = fast_exp2(fmaf(st[4 * j + e], p.scale_log2, -ls[col]));
          if (!unmasked) {
            const int key = key0 + 8 * (e >> 1), qi = q0 + col;
            const bool ok = qi < t_len && key < t_len &&
                            (!p.causal || qi + p.shift >= key);
            pr = ok ? pr : 0.f;
          }
          st[4 * j + e] = pr;
          dpt[4 * j + e] = pr * (dpt[4 * j + e] - dl[col]);
        }

      // dV += p^T dO and dK += ds^T Q over the tile's queries; ds^T is
      // split while the dV products run
      uint32_t phi[BQ / 16][4], plo[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split2<T>(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1], phi[kk][r],
                    plo[kk][r]);
      pin<D / 2>(dv);
      pin<D / 2>(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint64_t bd = sw128_desc(dot + kk * 16 * ROW_BYTES, S_PANEL,
                                       1024);
        wgmma_rs<D, F16>(dv, phi[kk], bd);
        wgmma_rs<D, F16>(dv, plo[kk], bd);
      }
      uint32_t dhi[BQ / 16][4], dlo[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split2<T>(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1], dhi[kk][r],
                    dlo[kk][r]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint64_t bq = sw128_desc(qt + kk * 16 * ROW_BYTES, S_PANEL,
                                       1024);
        wgmma_rs<D, F16>(dk, dhi[kk], bq);
        wgmma_rs<D, F16>(dk, dlo[kk], bq);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin<D / 2>(dv);
      pin<D / 2>(dk);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  store_rows<T, D>(p, 1, b, h, key0, dk, p.scale);
  store_rows<T, D>(p, 2, b, h, key0, dv, 1.f);
}

template <typename T, int D>
__global__ void __launch_bounds__(q_threads<D>(), 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const Params p) {
  constexpr int STAGES = Cfg<D>::Q_STAGES;
  constexpr int WGS = Cfg<D>::Q_WGS, ROWS = q_rows<D>();
  constexpr int NP = D / PANEL;
  constexpr int Q_PANEL = ROWS * ROW_BYTES;     // resident Q or dO
  constexpr int Q_BYTES = NP * Q_PANEL;
  constexpr int KV_PANEL = BK * ROW_BYTES;      // a streamed K or V tile
  constexpr int KV_BYTES = NP * KV_PANEL;
  constexpr bool F16 = std::is_same<T, __half>::value;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);
  uint8_t* sdo = sq + Q_BYTES;
  uint8_t* sk = sdo + Q_BYTES;                  // STAGES tiles
  uint8_t* sv = sk + STAGES * KV_BYTES;         // STAGES tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(sv + STAGES * KV_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh % p.heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;   // heaviest first
  const int t_len = p.t_len;
  // K tiles to visit: all, or under causal masking those holding a key
  // visible to some row of this tile (K1's rule)
  int n_kb = (t_len + BK - 1) / BK;
  if (p.causal) {
    const int last_key = q0 + min(ROWS, t_len - q0) - 1 + p.shift;
    if (last_key < 0)
      n_kb = 0;
    else if (last_key / BK + 1 < n_kb)
      n_kb = last_key / BK + 1;
  }

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WGS * 4);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == WGS * 4) {
    // ---- producer
    if (lane != 0 || n_kb == 0) return;
    mbar_expect_tx(qbar, 2 * Q_BYTES);
    load_rows<D>(sq, &tq, qbar, p.qpos, q0, h, b, ROWS);
    load_rows<D>(sdo, &tdo, qbar, p.dopos, q0, h, b, ROWS);
    for (int i = 0; i < n_kb; ++i) {
      const int s = i % STAGES, use = i / STAGES;
      if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
      mbar_expect_tx(&full[s], 2 * KV_BYTES);
      load_rows<D>(sk + s * KV_BYTES, &tk, &full[s], p.kpos, i * BK, h, b, BK);
      load_rows<D>(sv + s * KV_BYTES, &tv, &full[s], p.vpos, i * BK, h, b, BK);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. q0 + 64 wg + 63
  const int wg = warp / 4, w = warp % 4;
  const int g = lane / 4, c = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * w + g;       // and row0 + 8
  const int last_seen = q0 + 64 * wg + p.shift;     // last key of its row 0
  float lse2[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t at = size_t(bh) * p.t_pad + row0 + 8 * r;   // < t_pad
    lse2[r] = p.lse2[at];
    delta[r] = p.delta[at];
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  if (n_kb > 0) mbar_wait(qbar, 0);
  const uint8_t* qw = sq + 64 * wg * ROW_BYTES;
  const uint8_t* dow = sdo + 64 * wg * ROW_BYTES;
  for (int i = 0; i < n_kb; ++i) {
    const int s = i % STAGES;
    const int k0 = i * BK;
    mbar_wait(&full[s], (i / STAGES) & 1);
    // a key tile wholly in the causal future of this warpgroup's rows
    const bool skip = p.causal && k0 > last_seen + 63;
    if (!skip) {
      const uint8_t* kt = sk + s * KV_BYTES;
      const uint8_t* vt = sv + s * KV_BYTES;
      float sc[BK / 2], dp[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * Q_PANEL + (kk % 4) * 32;
        const int koff = (kk / 4) * KV_PANEL + (kk % 4) * 32;
        wgmma_ss<BK, F16, 0>(sc, sw128_desc(qw + off, 16, 1024),
                             sw128_desc(kt + koff, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * Q_PANEL + (kk % 4) * 32;
        const int koff = (kk / 4) * KV_PANEL + (kk % 4) * 32;
        wgmma_ss<BK, F16, 0>(dp, sw128_desc(dow + off, 16, 1024),
                             sw128_desc(vt + koff, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin<BK / 2>(sc);
      pin<BK / 2>(dp);

      // ds in place: register 4j + e is row row0 + 8 (e / 2), key
      // k0 + 8j + 2c + e % 2
      const bool unmasked =
          k0 + BK <= t_len && (!p.causal || k0 + BK - 1 <= last_seen);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float pr = fast_exp2(fmaf(sc[4 * j + e], p.scale_log2, -lse2[r]));
          if (!unmasked) {
            const int key = k0 + 8 * j + 2 * c + (e & 1);
            const bool ok = key < t_len &&
                            (!p.causal || row0 + 8 * r + p.shift >= key);
            pr = ok ? pr : 0.f;
          }
          dp[4 * j + e] = pr * (dp[4 * j + e] - delta[r]);
        }
      uint32_t dhi[BK / 16][4], dlo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split2<T>(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1], dhi[kk][r],
                    dlo[kk][r]);

      // dQ += ds K over the tile's keys
      pin<D / 2>(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t bk = sw128_desc(kt + kk * 16 * ROW_BYTES, KV_PANEL,
                                       1024);
        wgmma_rs<D, F16>(dq, dhi[kk], bk);
        wgmma_rs<D, F16>(dq, dlo[kk], bk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin<D / 2>(dq);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  store_rows<T, D>(p, 0, b, h, row0, dq, p.scale);
}

template <typename T, int D>
int launch(const void* const* in, const long long* st, const float* lse,
           const float* dlse, float* scratch, void* const* out,
           const long long* ost, int b, int h, int t, float scale,
           int causal, int q_offset, int k_offset, cudaStream_t stream) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  constexpr int BQ = Cfg<D>::BQ;
  enum { Q, K, V, O, DO };
  Params p;
  const int t_pad = (t + PAD - 1) / PAD * PAD;
  const int bh = b * h;
  p.lse2 = scratch;
  p.delta = scratch + size_t(bh) * t_pad;
  for (int i = 0; i < 3; ++i) {
    p.out[i] = out[i];
    for (int j = 0; j < 3; ++j) p.ost[i][j] = ost[3 * i + j];
  }
  p.heads = h;
  p.t_len = t;
  p.t_pad = t_pad;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  // Rows and keys are below 2^23, so clamping the offsets' difference to
  // +-2^25 changes no comparison and keeps every sum in int.
  p.shift = int(max(-(1LL << 25),
                    min(1LL << 25, (long long)q_offset - k_offset)));
  CUtensorMap maps[4];
  int* pos[4] = {&p.qpos, &p.kpos, &p.vpos, &p.dopos};
  const int ops[4] = {Q, K, V, DO};
  for (int i = 0; i < 4; ++i) {
    const long long* s = st + 3 * ops[i];
    const int err = make_map(&maps[i], in[ops[i]], f16, D, t, h, b, s[2],
                             s[1], s[0], BQ, pos[i]);
    if (err) return err;
  }
  auto dkdv = flash_bwd_dkdv_tc_kernel<T, D>;
  auto dq = flash_bwd_dq_tc_kernel<T, D>;
  static unsigned long long dkdv_set = 0, dq_set = 0;   // a bit per device
  int err;
  if ((err = allow_smem(dkdv, dkdv_smem<D>(), dkdv_set)) ||
      (err = allow_smem(dq, dq_smem<D>(), dq_set)))
    return err;
  const int rows = bh * t_pad;
  const long long* so = st + 3 * O;
  const long long* sg = st + 3 * DO;
  flash_bwd_prep_kernel<T><<<(rows + PREP_NT / 32 - 1) / (PREP_NT / 32),
                             PREP_NT, 0, stream>>>(
      static_cast<const T*>(in[O]), static_cast<const T*>(in[DO]), lse, dlse,
      scratch, scratch + size_t(bh) * t_pad, so[0], so[1], so[2], sg[0],
      sg[1], sg[2], h, t, t_pad, D, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  dkdv<<<dim3(bh, t_pad / kv_rows<D>()), kv_threads<D>(), dkdv_smem<D>(),
         stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  dq<<<dim3(bh, t_pad / q_rows<D>()), q_threads<D>(), dq_smem<D>(),
       stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 1 bfloat16, 2 float16; d: 64 or 128. in holds q, k, v, O, dO, each
// (batch, heads, t, d) with unit stride in d and its (batch, head, row)
// element strides in `strides` (15 values, in that operand order), every
// stride a multiple of 8 and every base 16-byte aligned. lse and dlse (may
// be null) are contiguous f32 (batch * heads, t). scratch is f32 of
// 2 * batch * heads * t_pad, t_pad = t rounded up to a multiple of 128.
// out holds dq, dk, dv, written through their (batch, head, row) element
// strides in out_strides (9 values), unit stride in d, 4-byte aligned.
// Launches on `stream`, never synchronises, and returns 0, a cudaError_t,
// or one of hopper.cuh's ERR_* codes.
extern "C" int flash_attn_bwd_tc(const void* const* in,
                                 const long long* strides, const void* lse,
                                 const void* dlse, void* scratch,
                                 void* const* out,
                                 const long long* out_strides, int batch,
                                 int heads, int t_len, int d, int dtype,
                                 float scale, int causal, int q_offset,
                                 int k_offset, void* stream) {
  if (batch <= 0 || heads <= 0 || t_len <= 0 ||
      (long long)batch * heads > 0x7fffffffLL ||
      (t_len + 63) / 64 > MAX_TILES ||   // the smallest CTA owns 64 rows
      (long long)batch * heads * ((t_len + PAD - 1) / PAD * PAD) >
          0x7fffffffLL)
    return ERR_SHAPE;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(dlse);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 1000 + d) {
    case 1064:
      return launch<__nv_bfloat16, 64>(in, strides, l, dl, sc, out,
                                       out_strides, batch, heads, t_len,
                                       scale, causal, q_offset, k_offset, s);
    case 1128:
      return launch<__nv_bfloat16, 128>(in, strides, l, dl, sc, out,
                                        out_strides, batch, heads, t_len,
                                        scale, causal, q_offset, k_offset, s);
    case 2064:
      return launch<__half, 64>(in, strides, l, dl, sc, out, out_strides,
                                batch, heads, t_len, scale, causal, q_offset,
                                k_offset, s);
    case 2128:
      return launch<__half, 128>(in, strides, l, dl, sc, out, out_strides,
                                 batch, heads, t_len, scale, causal, q_offset,
                                 k_offset, s);
    default:
      return ERR_SHAPE;
  }
}

extern "C" const char* flash_attn_bwd_tc_error_string(int err) {
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
