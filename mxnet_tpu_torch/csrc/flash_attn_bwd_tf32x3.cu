// Flash-attention backward in fp32 on Hopper's tensor cores (sm_90a) as
// 3xTF32: kernel K2, route "tf32x3".
//
// Replaces mxnet_tpu/ops/pallas_kernels.py:_flash_bwd_blockwise (:241), the
// backward that flash_attention_with_grad (:347) and flash_attention_with_lse
// (:300) pair with the Pallas forward (K1), for fp32 callers. It computes
// what flash_attn_bwd.cu (the CUDA-core route, which stays for the fp32
// inputs this kernel does not take) and flash_attn_bwd_tc.cu (16-bit)
// compute: for q, k, v, O, dO (B, H, T, D) f32, K1's row log-sum-exp lse
// and, optionally, its cotangent dlse,
//   delta = rowsum(dO * O) - dlse
//   p     = exp(scale * q k^T - lse), exactly 0 where the key is masked
//   ds    = p * (dO v^T - delta)
//   dq    = scale * ds k,  dk = scale * ds^T q,  dv = p^T dO
// in f32. Key j is visible to query i when both lie inside T and, under
// causal masking, q_offset + i >= k_offset + j (K1's rule). A row that
// sees no key has p = 0: its dq is exactly 0 and it adds nothing to dk or
// dv.
//
// Takes: f32; D in {64, 128}; q, k, v, O, dO with unit stride in D, every
// other stride a multiple of 4 elements and 16-byte-aligned bases
// (ops/kernels.py:_flash_bwd_route), read in place through their own
// (batch, head, row) strides. dq, dk and dv are written through their own
// strides, so the LM's three gradients land in one (B, T, 3H, D) buffer.
//
// Accuracy: every product is 3xTF32 (hopper.cuh: lo_a hi_b + hi_a lo_b +
// hi_a hi_b, ~2^-22 of |a b| dropped), as PyTorch's fp32 attention
// backward is (CUTLASS's OpMultiplyAddFastF32 on mma.sync).
//
// Bound on the H100 SXM at the LM's shape (8, 12, 1024, 64) fp32 causal:
// the five T x T x D products over the visible half are 3.22e10 FLOP;
// three TF32 passes at 495 TFLOP/s are 0.195 ms (at the 67 TFLOP/s of f32
// FMA 0.481 ms); q, k, v, O, dO read once and dq, dk, dv written once are
// 201 MB, 0.060 ms at 3.35 TB/s. Bound by operations.
//
// Design: flash_attn_bwd_tc.cu's structure, a delta pre-pass, a dk/dv
// kernel that walks the query tiles and a dq kernel that walks the key
// tiles, each output element written by one CTA: no atomics, and a second
// launch is bitwise equal.
// - TF32 wgmma has no transpose flags, so both shared-memory operands are
//   K-major. As loaded by TMA ([row][d]), Q, K, V and dO are the K-major
//   operands of S^T = K Q^T, dP^T = V dO^T, S = Q K^T and dP = dO V^T. The
//   products that reduce over rows -- dV = P^T dO, dK = dS^T Q (dk/dv
//   kernel) and dQ = dS K (dq kernel) -- need dO, Q and K transposed
//   ([d][row]): the consumers write those tiles' hi and lo parts
//   transposed into one swizzled tile as they split them, each row at the
//   column where the accumulator fragment puts it in the A fragment
//   (hopper.cuh: frag_col), so p^T, ds^T and ds go from the S / dP
//   accumulators to A registers with no shuffle. The same pass splits the
//   loaded tile in place (hi) with lo in a second buffer.
// - dk/dv kernel: one CTA per (batch * head, 64 KV_WGS keys), KV_WGS
//   consumer warpgroups and a producer warp. K and V arrive once and are
//   split once; Q, dO, lse and delta tiles of BOX queries stream through a
//   ring of stages (only the query tiles that can see a key of the CTA).
//   Every consumer thread splits each streamed tile (shared by the
//   warpgroups), fences the stores to the async proxy and meets the others
//   on a named barrier; a second barrier at the next tile keeps the split
//   buffers until every warpgroup's products have read them.
// - dq kernel: one CTA per (batch * head, 64 Q_WGS queries): Q and dO
//   resident and split once, K and V tiles of BOX keys streamed.
// - Causal: a warpgroup skips the math of a tile wholly in its keys' past
//   (dk/dv) or its rows' future (dq); only tiles that cross the diagonal
//   or T are masked element by element.
//
// Tiles (Cfg): D = 64: BOX = 32 rows a streamed tile, two consumer
// warpgroups a CTA in both kernels; D = 128: BOX = 16, one warpgroup.
// Shared memory: dk/dv K, V hi and lo 4 x 64 KV_WGS x D x 4, 2 stages of Q
// and dO, their lo parts and their transposed hi | lo: 208 KB; dq Q, dO hi
// and lo, 2 stages of K and V, their lo parts and K^T: 192 KB; one CTA per
// SM.
//
// What holds it back: the split passes (each streamed element read once
// and written four times, twice transposed) and two barriers a tile sit
// between the products; the dq kernel recomputes S and dP; one CTA per SM.
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int PAD = 128;                    // lse, delta rows padded to this
constexpr int PREP_NT = 128;                // pre-pass threads, a warp a row
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_TILES = 65535;            // gridDim.y

template <int D> struct Cfg;
// BOX: rows of a streamed tile (and of every TMA box); KV_WGS, Q_WGS:
// consumer warpgroups (64 rows each) of a dk/dv and a dq CTA; STAGES: ring
// depth of both.
template <> struct Cfg<64> {
  static constexpr int BOX = 32, KV_WGS = 2, Q_WGS = 2, STAGES = 2;
};
template <> struct Cfg<128> {
  static constexpr int BOX = 16, KV_WGS = 1, Q_WGS = 1, STAGES = 2;
};
template <int WGS>
__host__ __device__ constexpr int threads() { return WGS * 128 + 32; }

struct Params {
  const float* lse2;      // (B*H, t_pad): lse * log2(e)
  const float* delta;     // (B*H, t_pad)
  float* out[3];          // dq, dk, dv
  long long ost[3][3];    // their (batch, head, row) element strides
  int heads, t_len, t_pad;
  float scale, scale_log2;
  int causal, shift;      // shift = q_offset - k_offset, clamped
  int qpos, kpos, vpos, dopos;   // tensor-map positions (see coords)
};

template <int D>
constexpr int dkdv_smem() {
  constexpr int R = 64 * Cfg<D>::KV_WGS, BOX = Cfg<D>::BOX;
  constexpr int S = Cfg<D>::STAGES;
  // K, V hi and lo; the Q, dO stages; their lo and transposed hi | lo;
  // the lse, delta stages; 2 S + 1 mbarriers; 1 KB for the swizzle atom
  return 4 * R * D * 4 + 2 * S * BOX * D * 4 + 2 * BOX * D * 4 +
         2 * 2 * BOX * D * 4 + 2 * S * BOX * 4 + (2 * S + 1) * 8 + 1024;
}

template <int D>
constexpr int dq_smem() {
  constexpr int R = 64 * Cfg<D>::Q_WGS, BOX = Cfg<D>::BOX;
  constexpr int S = Cfg<D>::STAGES;
  // Q, dO hi and lo; the K, V stages; their lo; K^T hi | lo; mbarriers
  return 4 * R * D * 4 + 2 * S * BOX * D * 4 + 2 * BOX * D * 4 +
         2 * BOX * D * 4 + (2 * S + 1) * 8 + 1024;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// `rows` rows (a multiple of BOX) from row t of (b, h) into a tile of
// `rows` rows per 32-column panel, BOX rows a TMA box.
template <int D>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int pos, int t,
                                          int h, int b, int rows) {
  constexpr int BOX = Cfg<D>::BOX;
  for (int p = 0; p < D / PANEL32; ++p)
    for (int r = 0; r < rows; r += BOX) {
      int c1, c2, c3;
      coords(pos, t + r, h, b, c1, c2, c3);
      tma_load(dst + (p * rows + r) * ROW_BYTES, map, bar, p * PANEL32, c1,
               c2, c3);
    }
}

// Rows row0 and row0 + 8 of this thread's fragment (D / 2 f32) times
// `mul`, stored through out's strides where row < T.
template <int D>
__device__ __forceinline__ void store_rows(const Params& p, int which, int b,
                                           int h, int row0, const float* acc,
                                           float mul) {
  const int c = threadIdx.x % 4;
  const long long* st = p.ost[which];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.t_len) continue;
    float* o = p.out[which] + b * st[0] + h * st[1] + row * st[2] + 2 * c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[8 * j] = acc[4 * j + 2 * r] * mul;
      o[8 * j + 1] = acc[4 * j + 2 * r + 1] * mul;
    }
  }
}

// The three TF32 passes of D (64 x N) += A B over k8 steps 0..STEPS-1 of
// two K-major shared-memory operands, each given by its hi and lo bases:
// a_off(kk) and b_off(kk) are the byte offsets of step kk. acc = 0 at the
// first step overwrites D.
template <int N, int STEPS, typename AOff, typename BOff>
__device__ __forceinline__ void product_ss(float* d, const uint8_t* ah,
                                           const uint8_t* al,
                                           const uint8_t* bh,
                                           const uint8_t* bl, AOff a_off,
                                           BOff b_off) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    const int ao = a_off(kk), bo = b_off(kk);
    const uint64_t dah = sw128_desc(ah + ao, 16, 1024);
    const uint64_t dbh = sw128_desc(bh + bo, 16, 1024);
    wgmma_ss_tf32<N>(d, sw128_desc(al + ao, 16, 1024), dbh, kk > 0);
    wgmma_ss_tf32<N>(d, dah, sw128_desc(bl + bo, 16, 1024), 1);
    wgmma_ss_tf32<N>(d, dah, dbh, 1);
  }
}

// D (64 x N) += A B with A's hi and lo fragments in registers and B a
// transposed hi | lo tile of R reduction rows (split_tile_t).
template <int N, int R>
__device__ __forceinline__ void product_rs(float* d, uint32_t (*ahi)[4],
                                           uint32_t (*alo)[4],
                                           const uint8_t* bt) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
    const uint64_t bh = t_desc<R, N>(bt, kk, false);
    wgmma_rs_tf32<N>(d, alo[kk], bh);
    wgmma_rs_tf32<N>(d, ahi[kk], t_desc<R, N>(bt, kk, true));
    wgmma_rs_tf32<N>(d, ahi[kk], bh);
  }
}

// delta[r] = sum_d dO[r, d] O[r, d] - dlse[r] and lse2[r] = lse[r] log2(e)
// for the rows of (B*H, t_pad); rows past T get 0 (their keys and queries
// are masked wherever they are read).
__global__ void __launch_bounds__(PREP_NT)
flash_bwd_prep_f32_kernel(const float* __restrict__ o,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dlse, float* lse2,
                          float* delta, long long osb, long long osh,
                          long long ost, long long gsb, long long gsh,
                          long long gst, int heads, int t_len, int t_pad,
                          int d, int rows) {
  const int r = blockIdx.x * (PREP_NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int bh = r / t_pad, i = r % t_pad;
  if (i >= t_len) {
    if (lane == 0) lse2[r] = delta[r] = 0.f;
    return;
  }
  const int b = bh / heads, h = bh % heads;
  const float* orow = o + b * osb + h * osh + i * ost;
  const float* grow = dout + b * gsb + h * gsh + i * gst;
  float s = 0.f;
  for (int k = 2 * lane; k < d; k += 64) {
    const float2 x = *reinterpret_cast<const float2*>(orow + k);
    const float2 y = *reinterpret_cast<const float2*>(grow + k);
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

template <int D>
__global__ void __launch_bounds__(threads<Cfg<D>::KV_WGS>(), 1)
flash_bwd_dkdv_tf32x3_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const Params p) {
  constexpr int BQ = Cfg<D>::BOX, STAGES = Cfg<D>::STAGES;
  constexpr int WGS = Cfg<D>::KV_WGS, ROWS = 64 * WGS, NC = WGS * 128;
  constexpr int NP = D / PANEL32;               // 32-column panels
  constexpr int R_PANEL = ROWS * ROW_BYTES;     // resident K or V
  constexpr int R_BYTES = NP * R_PANEL;
  constexpr int S_PANEL = BQ * ROW_BYTES;       // a streamed Q or dO tile
  constexpr int S_BYTES = NP * S_PANEL;
  constexpr int T_BYTES = 2 * BQ * D * 4;       // transposed hi | lo
  extern __shared__ uint8_t smem_raw[];
  uint8_t* skh = align1024(smem_raw);           // K, then its hi part
  uint8_t* skl = skh + R_BYTES;
  uint8_t* svh = skl + R_BYTES;                 // V, then its hi part
  uint8_t* svl = svh + R_BYTES;
  uint8_t* sq = svl + R_BYTES;                  // STAGES tiles
  uint8_t* sdo = sq + STAGES * S_BYTES;         // STAGES tiles
  uint8_t* sql = sdo + STAGES * S_BYTES;
  uint8_t* sdol = sql + S_BYTES;
  uint8_t* sqt = sdol + S_BYTES;                // Q^T hi | lo
  uint8_t* sdot = sqt + T_BYTES;                // dO^T hi | lo
  float* slse = reinterpret_cast<float*>(sdot + T_BYTES);
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
    mbar_expect_tx(kvbar, 2 * R_BYTES);
    load_rows<D>(skh, &tk, kvbar, p.kpos, k0, h, b, ROWS);
    load_rows<D>(svh, &tv, kvbar, p.vpos, k0, h, b, ROWS);
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
  const int tid = threadIdx.x;                  // < NC
  const int wg = warp / 4, w = warp % 4;
  const int g = lane / 4, c = lane % 4;
  const int kw0 = k0 + 64 * wg;
  const int key0 = kw0 + 16 * w + g;            // and key0 + 8
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  if (n_it > 0) {
    mbar_wait(kvbar, 0);
    split_tile(skh, skl, R_BYTES, tid, NC);
    split_tile(svh, svl, R_BYTES, tid, NC);
    fence_async_smem();
  }
  const int kw = 64 * wg * ROW_BYTES;           // this warpgroup's keys
  auto a_off = [&](int kk) { return (kk / 4) * R_PANEL + kw + (kk % 4) * 32; };
  auto b_off = [](int kk) { return (kk / 4) * S_PANEL + (kk % 4) * 32; };
  for (int it = 0; it < n_it; ++it) {
    const int s = it % STAGES;
    const int q0 = (qb0 + it) * BQ;
    uint8_t* qt = sq + s * S_BYTES;
    uint8_t* dot = sdo + s * S_BYTES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    consumers_sync(NC);   // every warpgroup is done with the split buffers
    split_tile_t<BQ, D, true>(qt, sql, sqt, tid, NC);
    split_tile_t<BQ, D, true>(dot, sdol, sdot, tid, NC);
    fence_async_smem();
    consumers_sync(NC);
    // a query tile wholly in the causal past of this warpgroup's keys
    const bool skip = p.causal && q0 + BQ - 1 + p.shift < kw0;
    if (!skip) {
      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
      product_ss<BQ, D / 8>(st, skh, skl, qt, sql, a_off, b_off);
      product_ss<BQ, D / 8>(dpt, svh, svl, dot, sdol, a_off, b_off);
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
      uint32_t phi[BQ / 8][4], plo[BQ / 8][4];
      tf32_a_fragment<BQ>(st, phi, plo);
      pin<D / 2>(dv);
      pin<D / 2>(dk);
      wgmma_fence();
      product_rs<D, BQ>(dv, phi, plo, sdot);
      uint32_t dhi[BQ / 8][4], dlo[BQ / 8][4];
      tf32_a_fragment<BQ>(dpt, dhi, dlo);
      wgmma_fence();
      product_rs<D, BQ>(dk, dhi, dlo, sqt);
      wgmma_commit();
      wgmma_wait<0>();
      pin<D / 2>(dv);
      pin<D / 2>(dk);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  store_rows<D>(p, 1, b, h, key0, dk, p.scale);
  store_rows<D>(p, 2, b, h, key0, dv, 1.f);
}

template <int D>
__global__ void __launch_bounds__(threads<Cfg<D>::Q_WGS>(), 1)
flash_bwd_dq_tf32x3_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const Params p) {
  constexpr int BK = Cfg<D>::BOX, STAGES = Cfg<D>::STAGES;
  constexpr int WGS = Cfg<D>::Q_WGS, ROWS = 64 * WGS, NC = WGS * 128;
  constexpr int NP = D / PANEL32;
  constexpr int R_PANEL = ROWS * ROW_BYTES;     // resident Q or dO
  constexpr int R_BYTES = NP * R_PANEL;
  constexpr int S_PANEL = BK * ROW_BYTES;       // a streamed K or V tile
  constexpr int S_BYTES = NP * S_PANEL;
  constexpr int T_BYTES = 2 * BK * D * 4;       // K^T hi | lo
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sqh = align1024(smem_raw);           // Q, then its hi part
  uint8_t* sql = sqh + R_BYTES;
  uint8_t* sdoh = sql + R_BYTES;                // dO, then its hi part
  uint8_t* sdol = sdoh + R_BYTES;
  uint8_t* sk = sdol + R_BYTES;                 // STAGES tiles
  uint8_t* sv = sk + STAGES * S_BYTES;          // STAGES tiles
  uint8_t* skl = sv + STAGES * S_BYTES;
  uint8_t* svl = skl + S_BYTES;
  uint8_t* skt = svl + S_BYTES;                 // K^T hi | lo
  uint64_t* full = reinterpret_cast<uint64_t*>(skt + T_BYTES);
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
    mbar_expect_tx(qbar, 2 * R_BYTES);
    load_rows<D>(sqh, &tq, qbar, p.qpos, q0, h, b, ROWS);
    load_rows<D>(sdoh, &tdo, qbar, p.dopos, q0, h, b, ROWS);
    for (int i = 0; i < n_kb; ++i) {
      const int s = i % STAGES, use = i / STAGES;
      if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
      mbar_expect_tx(&full[s], 2 * S_BYTES);
      load_rows<D>(sk + s * S_BYTES, &tk, &full[s], p.kpos, i * BK, h, b, BK);
      load_rows<D>(sv + s * S_BYTES, &tv, &full[s], p.vpos, i * BK, h, b, BK);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. q0 + 64 wg + 63
  const int tid = threadIdx.x;
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

  if (n_kb > 0) {
    mbar_wait(qbar, 0);
    split_tile(sqh, sql, R_BYTES, tid, NC);
    split_tile(sdoh, sdol, R_BYTES, tid, NC);
    fence_async_smem();
  }
  const int qw = 64 * wg * ROW_BYTES;           // this warpgroup's rows
  auto a_off = [&](int kk) { return (kk / 4) * R_PANEL + qw + (kk % 4) * 32; };
  auto b_off = [](int kk) { return (kk / 4) * S_PANEL + (kk % 4) * 32; };
  for (int i = 0; i < n_kb; ++i) {
    const int s = i % STAGES;
    const int k0 = i * BK;
    uint8_t* kt = sk + s * S_BYTES;
    uint8_t* vt = sv + s * S_BYTES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    consumers_sync(NC);   // every warpgroup is done with the split buffers
    split_tile_t<BK, D, true>(kt, skl, skt, tid, NC);
    split_tile(vt, svl, S_BYTES, tid, NC);
    fence_async_smem();
    consumers_sync(NC);
    // a key tile wholly in the causal future of this warpgroup's rows
    const bool skip = p.causal && k0 > last_seen + 63;
    if (!skip) {
      float sc[BK / 2], dp[BK / 2];
      wgmma_fence();
      product_ss<BK, D / 8>(sc, sqh, sql, kt, skl, a_off, b_off);
      product_ss<BK, D / 8>(dp, sdoh, sdol, vt, svl, a_off, b_off);
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
      uint32_t dhi[BK / 8][4], dlo[BK / 8][4];
      tf32_a_fragment<BK>(dp, dhi, dlo);

      // dQ += ds K over the tile's keys
      pin<D / 2>(dq);
      wgmma_fence();
      product_rs<D, BK>(dq, dhi, dlo, skt);
      wgmma_commit();
      wgmma_wait<0>();
      pin<D / 2>(dq);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  store_rows<D>(p, 0, b, h, row0, dq, p.scale);
}

template <int D>
int launch(const void* const* in, const long long* st, const float* lse,
           const float* dlse, float* scratch, void* const* out,
           const long long* ost, int b, int h, int t, float scale,
           int causal, int q_offset, int k_offset, cudaStream_t stream) {
  constexpr int BOX = Cfg<D>::BOX;
  constexpr int KV_ROWS = 64 * Cfg<D>::KV_WGS, Q_ROWS = 64 * Cfg<D>::Q_WGS;
  enum { Q, K, V, O, DO };
  Params p;
  const int t_pad = (t + PAD - 1) / PAD * PAD;
  // a CTA per KV_ROWS keys and per Q_ROWS queries below t (not t_pad: at
  // D = 128 a grid over t_pad would pass MAX_TILES for T up to 65535 * 64)
  const int n_kv = (t + KV_ROWS - 1) / KV_ROWS;
  const int n_q = (t + Q_ROWS - 1) / Q_ROWS;
  if (n_kv > MAX_TILES || n_q > MAX_TILES) return ERR_SHAPE;
  const int bh = b * h;
  p.lse2 = scratch;
  p.delta = scratch + size_t(bh) * t_pad;
  for (int i = 0; i < 3; ++i) {
    p.out[i] = static_cast<float*>(out[i]);
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
    const int err = make_map_f32(&maps[i], in[ops[i]], D, t, h, b, s[2],
                                 s[1], s[0], BOX, pos[i]);
    if (err) return err;
  }
  auto dkdv = flash_bwd_dkdv_tf32x3_kernel<D>;
  auto dq = flash_bwd_dq_tf32x3_kernel<D>;
  static unsigned long long dkdv_set = 0, dq_set = 0;   // a bit per device
  int err;
  if ((err = allow_smem(dkdv, dkdv_smem<D>(), dkdv_set)) ||
      (err = allow_smem(dq, dq_smem<D>(), dq_set)))
    return err;
  const int rows = bh * t_pad;
  const long long* so = st + 3 * O;
  const long long* sg = st + 3 * DO;
  flash_bwd_prep_f32_kernel<<<(rows + PREP_NT / 32 - 1) / (PREP_NT / 32),
                              PREP_NT, 0, stream>>>(
      static_cast<const float*>(in[O]), static_cast<const float*>(in[DO]),
      lse, dlse, scratch, scratch + size_t(bh) * t_pad, so[0], so[1], so[2],
      sg[0], sg[1], sg[2], h, t, t_pad, D, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  dkdv<<<dim3(bh, n_kv), threads<Cfg<D>::KV_WGS>(), dkdv_smem<D>(),
         stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  dq<<<dim3(bh, n_q), threads<Cfg<D>::Q_WGS>(), dq_smem<D>(),
       stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32 (flash_attn_bwd_tc's signature); d: 64 or 128. in
// holds q, k, v, O, dO, each f32 (batch, heads, t, d) with unit stride in
// d and its (batch, head, row) element strides in
// `strides` (15 values, in that operand order), every stride a multiple
// of 4 and every base 16-byte aligned. lse and dlse (may be null) are
// contiguous f32 (batch * heads, t). scratch is f32 of
// 2 * batch * heads * t_pad, t_pad = t rounded up to a multiple of 128.
// out holds dq, dk, dv, written through their (batch, head, row) element
// strides in out_strides (9 values), unit stride in d. Launches on
// `stream`, never synchronises, and returns 0, a cudaError_t, or one of
// hopper.cuh's ERR_* codes.
extern "C" int flash_attn_bwd_tf32x3(const void* const* in,
                                     const long long* strides,
                                     const void* lse, const void* dlse,
                                     void* scratch, void* const* out,
                                     const long long* out_strides, int batch,
                                     int heads, int t_len, int d, int dtype,
                                     float scale, int causal, int q_offset,
                                     int k_offset, void* stream) {
  if (dtype != 0 || batch <= 0 || heads <= 0 || t_len <= 0 ||
      (long long)batch * heads > 0x7fffffffLL ||
      (long long)batch * heads * ((t_len + PAD - 1) / PAD * PAD) >
          0x7fffffffLL)
    return ERR_SHAPE;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(dlse);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64>(in, strides, l, dl, sc, out, out_strides, batch, heads,
                      t_len, scale, causal, q_offset, k_offset, s);
  if (d == 128)
    return launch<128>(in, strides, l, dl, sc, out, out_strides, batch,
                       heads, t_len, scale, causal, q_offset, k_offset, s);
  return ERR_SHAPE;
}

// The tiles of head dimension d: rows a streamed tile, keys a dk/dv CTA,
// queries a dq CTA; 0 if d is not taken.
extern "C" int flash_attn_bwd_tf32x3_tiles(int d, int* box, int* kv_rows,
                                           int* q_rows) {
  if (d == 64) {
    *box = Cfg<64>::BOX;
    *kv_rows = 64 * Cfg<64>::KV_WGS;
    *q_rows = 64 * Cfg<64>::Q_WGS;
    return 0;
  }
  if (d == 128) {
    *box = Cfg<128>::BOX;
    *kv_rows = 64 * Cfg<128>::KV_WGS;
    *q_rows = 64 * Cfg<128>::Q_WGS;
    return 0;
  }
  return ERR_SHAPE;
}

extern "C" const char* flash_attn_bwd_tf32x3_error_string(int err) {
  switch (err) {
    case ERR_NO_ENCODER:
      return "cuTensorMapEncodeTiled is not available from the driver";
    case ERR_ENCODE:
      return "cuTensorMapEncodeTiled refused a tensor map (strides or "
             "base address not 16-byte aligned?)";
    case ERR_SHAPE:
      return "shape, dtype or head dimension the 3xTF32 kernel does not "
             "take";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}
